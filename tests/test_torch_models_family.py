"""TransH and DistMult (``repro_torch.core.models.{transh,distmult}``) and
the ``repro_torch.core.transe`` shim against the reference, on the
reference's init tables carried across by ``repro_torch.convert``.

Tolerances: energies and scorers rtol/atol 1e-6 (the port sums over the
embedding axis in index order, XLA in its own order, so the two differ in
the last few ulps); losses, steps, epochs and gradients 1e-5, as for
TransE (``tests/test_torch_models.py``); ranks and top-k ids exactly.
``candidate_slice_energies`` is held bitwise against the port's own
``candidate_energies``: the reference's DistMult breaks that contract
(its XLA matmul over a slice is not the slice of the matmul), so its
slices are no oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transe as ref_transe
from repro.core.models import get_model as ref_get_model
from repro.core.models.base import KGConfig as RefKGConfig
from repro.serve.kg_engine import KGQueryEngine as RefEngine
from repro_torch.core import models as port_models
from repro_torch.core import transe as port_transe
from repro_torch.kernels import ops as port_ops
from repro_torch.serve.kg_engine import KGQueryEngine as PortEngine

from test_torch_parity_helpers import DIM, port_params

TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
N_ENT, N_REL = 97, 7
MODELS = ("transh", "distmult")
NORMS = ("l1", "l2")


def ref_model_tables(name, seed=3):
    """The reference's init of model ``name`` as numpy tables."""
    params = ref_get_model(name).init_params(
        jax.random.PRNGKey(seed), RefKGConfig(N_ENT, N_REL, DIM))
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def tables():
    return {name: ref_model_tables(name) for name in MODELS + ("transe",)}


@pytest.fixture(scope="module")
def triplets():
    rng = np.random.default_rng(5)
    return np.stack([rng.integers(0, N_ENT, 40), rng.integers(0, N_REL, 40),
                     rng.integers(0, N_ENT, 40)], axis=1).astype(np.int32)


def _pair(tables, name):
    t = tables[name]
    return (ref_get_model(name), {k: jnp.asarray(v) for k, v in t.items()},
            port_models.get_model(name), port_params(t))


def _batches(lead, B, seed):
    """Positive batches and corruptions (one side changed) ``lead + (B, 3)``."""
    rng = np.random.default_rng(seed)
    shape = lead + (B,)
    pos = np.stack([rng.integers(0, N_ENT, shape), rng.integers(0, N_REL,
                    shape), rng.integers(0, N_ENT, shape)], -1)
    neg = pos.copy()
    side = np.where(rng.random(shape) < 0.5, 0, 2)
    np.put_along_axis(neg, side[..., None],
                      rng.integers(0, N_ENT, shape)[..., None], -1)
    return pos.astype(np.int32), neg.astype(np.int32)


def _cfgs(norm="l1", normalize="epoch"):
    kw = dict(dim=DIM, margin=1.0, norm=norm, learning_rate=0.05,
              normalize=normalize)
    return RefKGConfig(N_ENT, N_REL, **kw), port_models.KGConfig(
        N_ENT, N_REL, **kw)


# ---------------------------------------------------------------------------
# Scorers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_energy(tables, triplets, name, norm):
    rm, rp, pm, pp = _pair(tables, name)
    want = np.asarray(rm.energy(rp, jnp.asarray(triplets), norm))
    got = pm.energy(pp, torch.as_tensor(triplets), norm).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("side", ["tail", "head"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_candidate_energies(tables, triplets, name, norm, side):
    rm, rp, pm, pp = _pair(tables, name)
    want = np.asarray(rm.candidate_energies(
        rp, jnp.asarray(triplets), side, norm))
    got = pm.candidate_energies(pp, torch.as_tensor(triplets), side, norm)
    assert got.shape == (len(triplets), N_ENT)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_relation_energies(tables, triplets, name, norm):
    rm, rp, pm, pp = _pair(tables, name)
    want = np.asarray(rm.relation_energies(rp, jnp.asarray(triplets), norm))
    got = pm.relation_energies(pp, torch.as_tensor(triplets), norm)
    assert got.shape == (len(triplets), N_REL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", MODELS)
def test_normalize(tables, name):
    """``normalize`` against the reference, and ``normalize_rows`` on a
    slice of rows equal to the slice of ``normalize`` bitwise, table by
    table (the sparse transport's contract)."""
    rm, rp, pm, pp = _pair(tables, name)
    want = rm.normalize(rp)
    got = pm.normalize(pp)
    ids = torch.tensor([5, 0, 3, 3])
    for table in pp:
        np.testing.assert_allclose(got[table].numpy(),
                                   np.asarray(want[table]), **TOL)
        np.testing.assert_allclose(
            pm.normalize_rows(table, pp[table]).numpy(),
            np.asarray(rm.normalize_rows(table, rp[table])), **TOL)
        assert torch.equal(pm.normalize_rows(table, pp[table][ids]),
                           got[table][ids])


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", ("transe",) + MODELS)
def test_candidate_slice_energies_bitwise(tables, triplets, name, norm):
    """Every shard's scan is the matching columns of the full matrix
    bitwise, the last (short) shard included; and the generic fallback
    of the base class agrees."""
    _, _, pm, pp = _pair(tables, name)
    trip = torch.as_tensor(triplets)
    for side in ("tail", "head"):
        full = pm.candidate_energies(pp, trip, side, norm)
        for lo, n in ((0, 1), (0, 32), (13, 29), (64, 32), (96, 1),
                      (0, N_ENT)):
            got = pm.candidate_slice_energies(pp, trip, side, norm, lo=lo,
                                              n=n)
            assert got.shape == (len(triplets), n)
            assert torch.equal(got, full[:, lo:lo + n]), (side, lo, n)
            generic = port_models.KGModel.candidate_slice_energies(
                pm, pp, trip, side, norm, lo=lo, n=n)
            assert torch.equal(generic, got)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_generic_scorers_match_closed_forms(tables, triplets, name, norm):
    """The base class's substitute-every-candidate fallbacks agree with
    each model's closed forms (port against port)."""
    _, _, pm, pp = _pair(tables, name)
    trip = torch.as_tensor(triplets)
    for side in ("tail", "head"):
        np.testing.assert_allclose(
            port_models.KGModel.candidate_energies(
                pm, pp, trip, side, norm).numpy(),
            pm.candidate_energies(pp, trip, side, norm).numpy(), **TOL)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_ranks_and_topk_match_reference(tables, triplets, name, norm):
    """Entity rank counts (both sides) and the query engine's top-k ids
    equal the reference's exactly, energies at 1e-6."""
    rm, rp, pm, pp = _pair(tables, name)
    from repro.kernels import ops as ref_ops

    for side in ("tail", "head"):
        want = np.asarray(ref_ops.entity_rank_counts(
            rp, jnp.asarray(triplets), side, norm=norm, model=name))
        got = port_ops.entity_rank_counts(
            pp, torch.as_tensor(triplets), side, norm=norm, model=name)
        np.testing.assert_array_equal(got.numpy(), want)
    ref_eng = RefEngine(name, rp, norm=norm)
    port_eng = PortEngine(name, pp, norm=norm)
    h, r, t = triplets[:, 0], triplets[:, 1], triplets[:, 2]
    for call, args in (("query_tails", (h, r)), ("query_heads", (t, r)),
                       ("query_relations", (h, t))):
        want = getattr(ref_eng, call)(*args, k=5)
        got = getattr(port_eng, call)(*args, k=5)
        np.testing.assert_array_equal(got.ids, np.asarray(want.ids))
        np.testing.assert_allclose(got.energies, np.asarray(want.energies),
                                   **TOL)


def test_init_params_seeded():
    cfg = port_models.KGConfig(N_ENT, N_REL, dim=DIM)
    bound = 6.0 / DIM ** 0.5
    for name, unit in (("transh", ("rel", "norm")), ("distmult", ())):
        pm = port_models.get_model(name)
        a = pm.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        b = pm.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        assert set(a) == set(pm.param_roles())
        for table, p in a.items():
            rows = N_ENT if pm.param_roles()[table] == "ent" else N_REL
            assert p.shape == (rows, DIM) and torch.equal(p, b[table])
            if table in unit:
                np.testing.assert_allclose(
                    torch.linalg.vector_norm(p, dim=1).numpy(), 1.0,
                    rtol=1e-6)
            else:
                assert float(p.abs().max()) <= bound
    transh = port_models.get_model("transh").init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu")
    distmult = port_models.get_model("distmult").init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu")
    # both draw entities first from the same generator
    assert torch.equal(transh["ent"], distmult["ent"])


# ---------------------------------------------------------------------------
# Training math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_losses_match_reference(tables, name, norm):
    rm, rp, pm, pp = _pair(tables, name)
    pos, neg = _batches((), 48, 1)
    args = (rp, jnp.asarray(pos), jnp.asarray(neg))
    want_pair = np.asarray(rm.per_pair_loss(*args, margin=1.0, norm=norm))
    want_mean = float(rm.margin_loss(*args, margin=1.0, norm=norm))
    pargs = (pm, pp, torch.tensor(pos), torch.tensor(neg))
    pair = port_ops.kg_pair_loss(*pargs, margin=1.0, norm=norm).numpy()
    mean = float(port_ops.kg_margin_loss(*pargs, margin=1.0, norm=norm))
    np.testing.assert_allclose(pair, want_pair, **STEP_TOL)
    np.testing.assert_allclose(mean, want_mean, **STEP_TOL)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_sgd_step_matches_reference(tables, name, norm):
    rm, rp, pm, pp = _pair(tables, name)
    rcfg, pcfg = _cfgs(norm, normalize="step")
    pos, neg = _batches((), 32, 2)
    want, want_loss = rm.sgd_step(rp, jnp.asarray(pos), jnp.asarray(neg),
                                  rcfg)
    got, loss = pm.sgd_step(pp, torch.tensor(pos), torch.tensor(neg), pcfg)
    np.testing.assert_allclose(float(loss), float(want_loss), **STEP_TOL)
    for table in pp:
        np.testing.assert_allclose(got[table].numpy(),
                                   np.asarray(want[table]), **STEP_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_run_epoch_matches_reference(tables, name):
    """Params and mean loss at the step tolerance; the touch counts
    exactly; the per-key loss sums at 1e-5."""
    rm, rp, pm, pp = _pair(tables, name)
    rcfg, pcfg = _cfgs("l2" if name == "transh" else "l1")
    pos, neg = _batches((4,), 32, 3)
    want, wstats = rm.run_epoch(rp, jnp.asarray(pos), jnp.asarray(neg), rcfg)
    got, stats = pm.run_epoch(pp, torch.tensor(pos), torch.tensor(neg), pcfg)
    for table in pp:
        np.testing.assert_allclose(got[table].numpy(),
                                   np.asarray(want[table]), **STEP_TOL)
    np.testing.assert_allclose(float(stats.mean_loss),
                               float(wstats.mean_loss), **STEP_TOL)
    for field in ("ent_count", "rel_count"):
        np.testing.assert_array_equal(getattr(stats, field).numpy(),
                                      np.asarray(getattr(wstats, field)))
    for field in ("ent_loss", "rel_loss"):
        np.testing.assert_allclose(getattr(stats, field).numpy(),
                                   np.asarray(getattr(wstats, field)),
                                   **STEP_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_run_epoch_stacked_workers_equal_separate_runs(tables, name):
    """W workers stacked into ``(W, N, k)`` tables, every table of the
    model included, give each worker bitwise what a run on its own copy
    gives."""
    _, _, pm, pp = _pair(tables, name)
    _, pcfg = _cfgs()
    pos, neg = (torch.tensor(a) for a in _batches((3, 4), 16, 4))
    stacked = {n: p.unsqueeze(0).repeat(3, 1, 1) for n, p in pp.items()}
    got, stats = pm.run_epoch(stacked, pos, neg, pcfg)
    for w in range(3):
        one, ostats = pm.run_epoch(pp, pos[w], neg[w], pcfg)
        for table in pp:
            assert torch.equal(got[table][w], one[table])
        for field in ("mean_loss", "ent_count", "ent_loss", "rel_count",
                      "rel_loss"):
            assert torch.equal(getattr(stats, field)[w],
                               getattr(ostats, field))


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_batch_gradients_matches_reference(tables, name, norm):
    """BGD's Map: per-worker losses and gradients of one shared set of
    tables against the reference's ``batch_gradients`` per worker."""
    rm, rp, pm, pp = _pair(tables, name)
    rcfg, pcfg = _cfgs(norm)
    pos, neg = _batches((3,), 24, 5)
    losses, grads = pm.batch_gradients(pp, torch.tensor(pos),
                                       torch.tensor(neg), pcfg)
    assert grads["ent"].shape == (3, N_ENT, DIM)
    for w in range(3):
        want_loss, want = rm.batch_gradients(
            rp, jnp.asarray(pos[w]), jnp.asarray(neg[w]), rcfg)
        np.testing.assert_allclose(float(losses[w]), float(want_loss),
                                   **STEP_TOL)
        for table in pp:
            np.testing.assert_allclose(grads[table][w].numpy(),
                                       np.asarray(want[table]),
                                       rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The core/transe.py shim
# ---------------------------------------------------------------------------


def test_transe_shim_bit_for_bit(tables):
    """Every function of the shim is the registered TransE's, bit for bit,
    and its aliases are the shared types (the port's counterpart of
    ``tests/test_kg_api.py::test_transe_shim_bit_for_bit``); the shim's
    energies match the reference shim's at 1e-6."""
    model = port_models.get_model("transe")
    pp = port_params(tables["transe"])
    assert port_transe.TransEConfig is port_models.KGConfig
    assert port_transe.EpochStats is port_models.EpochStats
    cfg = port_transe.TransEConfig(N_ENT, N_REL, dim=DIM,
                                   learning_rate=0.05)
    a = port_transe.init_params(torch.Generator().manual_seed(2), cfg,
                                device="cpu")
    b = model.init_params(torch.Generator().manual_seed(2), cfg,
                          device="cpu")
    assert all(torch.equal(a[n], b[n]) for n in b)
    pos, neg = (torch.tensor(x) for x in _batches((4,), 16, 8))
    got, gstats = port_transe.run_epoch(pp, pos, neg, cfg)
    want, wstats = model.run_epoch(pp, pos, neg, cfg)
    assert all(torch.equal(got[n], want[n]) for n in want)
    assert torch.equal(gstats.mean_loss, wstats.mean_loss)
    for fn, same in ((port_transe.sgd_step, model.sgd_step),
                     (port_transe.batch_gradients, model.batch_gradients)):
        x, y = fn(pp, pos[0], neg[0], cfg), same(pp, pos[0], neg[0], cfg)
        tabs = [o for o in (x + y) if isinstance(o, dict)]
        assert all(torch.equal(tabs[0][n], tabs[1][n]) for n in pp)
        loss = [o for o in (x + y) if not isinstance(o, dict)]
        assert torch.equal(loss[0], loss[1])
    normed = port_transe.normalize_entities(pp)
    assert all(torch.equal(normed[n], model.normalize(pp)[n]) for n in pp)
    assert torch.equal(
        port_transe.margin_loss(pp, pos[0], neg[0], margin=1.0, norm="l2"),
        model.margin_loss(pp, pos[0], neg[0], margin=1.0, norm="l2"))
    assert torch.equal(
        port_transe.per_pair_loss(pp, pos[0], neg[0], margin=1.0, norm="l1"),
        model.per_pair_loss(pp, pos[0], neg[0], margin=1.0, norm="l1"))
    rp = {n: jnp.asarray(v) for n, v in tables["transe"].items()}
    np.testing.assert_allclose(
        port_transe.energy(pp, pos[0], "l1").numpy(),
        np.asarray(ref_transe.energy(rp, jnp.asarray(pos[0].numpy()),
                                     "l1")), **TOL)
