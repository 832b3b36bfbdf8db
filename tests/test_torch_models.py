"""``repro_torch.core.models`` (TransE, the registry) against the reference
on tables carried across by ``repro_torch.convert``.

Energies are held at rtol 1e-6 and atol 1e-6 in fp32: the port sums each
distance over the embedding axis in index order, XLA in an order of its
own choosing (vectorized partial sums, fused multiply-adds), so the two
may differ in the last few ulps and no more.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.models import get_model as ref_get_model
from repro.core.models.base import KGConfig as RefKGConfig
from repro_torch.core import models as port_models
from repro_torch.core.models import base as port_base
from repro_torch.kernels import ops as port_ops

from test_torch_parity_helpers import DIM, ref_tables, port_params

TOL = dict(rtol=1e-6, atol=1e-6)
N_ENT, N_REL = 97, 7


@pytest.fixture(scope="module")
def tables():
    return ref_tables(N_ENT, N_REL, DIM, seed=3)


@pytest.fixture(scope="module")
def triplets():
    rng = np.random.default_rng(5)
    return np.stack([rng.integers(0, N_ENT, 40), rng.integers(0, N_REL, 40),
                     rng.integers(0, N_ENT, 40)], axis=1).astype(np.int32)


def _models(tables):
    return (ref_get_model("transe"), {k: jnp.asarray(v) for k, v in
                                      tables.items()},
            port_models.get_model("transe"), port_params(tables))


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_energy(tables, triplets, norm):
    rm, rp, pm, pp = _models(tables)
    want = np.asarray(rm.energy(rp, jnp.asarray(triplets), norm))
    got = pm.energy(pp, torch.as_tensor(triplets), norm).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("side", ["tail", "head"])
def test_candidate_energies(tables, triplets, norm, side):
    rm, rp, pm, pp = _models(tables)
    want = np.asarray(rm.candidate_energies(
        rp, jnp.asarray(triplets), side, norm))
    got = pm.candidate_energies(pp, torch.as_tensor(triplets), side, norm)
    assert got.shape == (len(triplets), N_ENT)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_relation_energies(tables, triplets, norm):
    rm, rp, pm, pp = _models(tables)
    want = np.asarray(rm.relation_energies(rp, jnp.asarray(triplets), norm))
    got = pm.relation_energies(pp, torch.as_tensor(triplets), norm)
    assert got.shape == (len(triplets), N_REL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_generic_scorers_match_closed_forms(tables, triplets, norm):
    """The base class's substitute-every-candidate fallbacks agree with
    TransE's closed forms (port against port)."""
    pm = port_models.get_model("transe")
    pp = port_params(tables)
    trip = torch.as_tensor(triplets)
    generic = port_base.KGModel
    for side in ("tail", "head"):
        np.testing.assert_allclose(
            generic.candidate_energies(pm, pp, trip, side, norm).numpy(),
            pm.candidate_energies(pp, trip, side, norm).numpy(), **TOL)
    np.testing.assert_allclose(
        generic.relation_energies(pm, pp, trip, norm).numpy(),
        pm.relation_energies(pp, trip, norm).numpy(), **TOL)


def test_normalize(tables):
    rm, rp, pm, pp = _models(tables)
    want = rm.normalize(rp)
    got = pm.normalize(pp)
    for name in ("ent", "rel"):
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), **TOL)


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("side", ["tail", "head"])
def test_fused_rank_counts_cpu(tables, triplets, norm, side):
    """On CPU tables the fused hook runs the kernel's plain version; its
    counts equal the reference's pure-jnp count over the candidate matrix
    under L1.  Under L2 the fused gold distance is the direct form and the
    candidates' the expanded one, so the gold itself may count: at most
    one rank apart, as in the reference."""
    rm, rp, pm, pp = _models(tables)
    trip = torch.as_tensor(triplets)
    want = np.asarray(jax.jit(
        lambda p, t: jnp.sum(
            rm.candidate_energies(p, t, side, norm)
            < rm.candidate_energies(p, t, side, norm)[
                jnp.arange(t.shape[0]),
                t[:, 2] if side == "tail" else t[:, 0]][:, None],
            axis=1))(rp, jnp.asarray(triplets)))
    got = port_ops.entity_rank_counts(pp, trip, side, norm=norm).numpy()
    if norm == "l1":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= 1)


def test_init_params_seeded():
    cfg = port_models.KGConfig(N_ENT, N_REL, dim=DIM)
    pm = port_models.get_model("transe")
    a = pm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    b = pm.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    c = pm.init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    bound = 6.0 / DIM ** 0.5
    assert a["ent"].shape == (N_ENT, DIM) and a["rel"].shape == (N_REL, DIM)
    assert torch.equal(a["ent"], b["ent"]) and torch.equal(a["rel"], b["rel"])
    assert not torch.equal(a["ent"], c["ent"])
    assert float(a["ent"].abs().max()) <= bound
    np.testing.assert_allclose(
        torch.linalg.vector_norm(a["rel"], dim=1).numpy(), 1.0, rtol=1e-6)


def test_registry():
    assert port_models.available() == ("distmult", "transe", "transh")
    for name in port_models.available():
        assert port_models.get_model(name).name == name
        assert port_models.get_model(name).param_roles() == \
            ref_get_model(name).param_roles()
    with pytest.raises(ValueError, match="unknown KG model"):
        port_models.get_model("rotate")
    with pytest.raises(ValueError, match="norm"):
        port_models.dissimilarity(torch.ones(2, 3), "l3")


# ---------------------------------------------------------------------------
# The training half: losses, steps, epochs with their touch stats.  Params
# are held at rtol/atol 1e-5 after steps of lr 0.05: the port's gradient is
# the kernel's closed form summed in a fixed order, the reference's
# jax.grad of margin_loss, and the two agree to the reference's own
# gradient tolerance (rtol 1e-4, atol 1e-5) times the learning rate.
# Hinges subtract sums of ~16 terms of magnitude ~1 that the two packages
# add in different orders: they are held at 1e-5 of those sums.
# ---------------------------------------------------------------------------

STEP_TOL = dict(rtol=1e-5, atol=1e-5)


def _train_cfgs(norm="l1", normalize="epoch"):
    kw = dict(dim=DIM, margin=1.0, norm=norm, learning_rate=0.05,
              normalize=normalize)
    return (RefKGConfig(N_ENT, N_REL, **kw),
            port_models.KGConfig(N_ENT, N_REL, **kw))


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


class NotFused(port_base.KGModel):
    """TransE's energy without the fused kernels: trains by torch autograd
    of ``per_pair_loss``."""
    name = "transe_unfused"
    energy = port_models.get_model("transe").energy.__func__


def test_kgconfig_validates_as_the_reference():
    for bad in (dict(norm="l3"), dict(normalize="always"),
                dict(negatives="pairs"), dict(neg_candidates=-1)):
        with pytest.raises(ValueError):
            RefKGConfig(4, 2, **bad)
        with pytest.raises(ValueError):
            port_models.KGConfig(4, 2, **bad)
    joint = port_models.KGConfig(4, 2, negatives="joint", neg_candidates=8)
    assert (joint.negatives, joint.neg_candidates) == ("joint", 8)
    cfg = port_models.KGConfig(4, 2)
    assert (cfg.margin, cfg.norm, cfg.learning_rate, cfg.normalize,
            cfg.sampling) == (1.0, "l1", 0.01, "epoch", "unif")


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_losses_match_reference(tables, norm, fused):
    rm, rp, pm, pp = _models(tables)
    pos, neg = _batches((), 48, 1)
    want_pair = np.asarray(rm.per_pair_loss(
        rp, jnp.asarray(pos), jnp.asarray(neg), margin=1.0, norm=norm))
    want_mean = float(rm.margin_loss(
        rp, jnp.asarray(pos), jnp.asarray(neg), margin=1.0, norm=norm))
    model = pm if fused else NotFused()
    args = (model, pp, torch.tensor(pos), torch.tensor(neg))
    pair = port_ops.kg_pair_loss(*args, margin=1.0, norm=norm).numpy()
    mean = float(port_ops.kg_margin_loss(*args, margin=1.0, norm=norm))
    d = rm.energy(rp, jnp.asarray(pos), norm) + rm.energy(
        rp, jnp.asarray(neg), norm)
    assert np.all(np.abs(pair - want_pair) <= 1e-5 * (1 + np.asarray(d)))
    np.testing.assert_allclose(mean, want_mean, **STEP_TOL)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_sgd_step_matches_reference(tables, norm, fused):
    rm, rp, pm, pp = _models(tables)
    rcfg, pcfg = _train_cfgs(norm, normalize="step")
    pos, neg = _batches((), 32, 2)
    want, want_loss = rm.sgd_step(rp, jnp.asarray(pos), jnp.asarray(neg),
                                  rcfg)
    model = pm if fused else NotFused()
    got, loss = model.sgd_step(pp, torch.tensor(pos), torch.tensor(neg),
                               pcfg)
    np.testing.assert_allclose(float(loss), float(want_loss), **STEP_TOL)
    for name in ("ent", "rel"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **STEP_TOL)


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_run_epoch_matches_reference(tables, norm):
    """Params and mean loss at the step tolerance; the touch counts
    exactly; the per-key loss sums at 1e-5 (sums of hinges)."""
    rm, rp, pm, pp = _models(tables)
    rcfg, pcfg = _train_cfgs(norm)
    pos, neg = _batches((4,), 32, 3)
    want, wstats = rm.run_epoch(rp, jnp.asarray(pos), jnp.asarray(neg), rcfg)
    got, stats = pm.run_epoch(pp, torch.tensor(pos), torch.tensor(neg), pcfg)
    for name in ("ent", "rel"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **STEP_TOL)
    np.testing.assert_allclose(float(stats.mean_loss),
                               float(wstats.mean_loss), **STEP_TOL)
    for field in ("ent_count", "rel_count"):
        np.testing.assert_array_equal(getattr(stats, field).numpy(),
                                      np.asarray(getattr(wstats, field)))
    for field in ("ent_loss", "rel_loss"):
        np.testing.assert_allclose(getattr(stats, field).numpy(),
                                   np.asarray(getattr(wstats, field)),
                                   **STEP_TOL)


def test_run_epoch_stacked_workers_equal_separate_runs(tables):
    """W workers stacked into ``(W, N, k)`` tables run side by side give
    each worker bitwise what a run on its own copy gives (port against
    port: the stacked step is one launch per step on the card)."""
    _, _, pm, pp = _models(tables)
    _, pcfg = _train_cfgs()
    pos, neg = (torch.tensor(a) for a in _batches((3, 4), 16, 4))
    stacked = {n: p.unsqueeze(0).repeat(3, 1, 1) for n, p in pp.items()}
    got, stats = pm.run_epoch(stacked, pos, neg, pcfg)
    assert stats.ent_count.shape == (3, N_ENT)
    assert stats.mean_loss.shape == (3,)
    for w in range(3):
        one, ostats = pm.run_epoch(pp, pos[w], neg[w], pcfg)
        for name in ("ent", "rel"):
            assert torch.equal(got[name][w], one[name])
        for field in ("mean_loss", "ent_count", "ent_loss", "rel_count",
                      "rel_loss"):
            assert torch.equal(getattr(stats, field)[w],
                               getattr(ostats, field))


def test_run_epoch_without_touch_losses(tables):
    """``touch_losses=False`` (every Reduce but ``miniloss_perkey``) leaves
    the loss sums out and changes nothing else, bitwise."""
    _, _, pm, pp = _models(tables)
    _, pcfg = _train_cfgs()
    pos, neg = (torch.tensor(a) for a in _batches((2, 4), 16, 7))
    stacked = {n: p.unsqueeze(0).repeat(2, 1, 1) for n, p in pp.items()}
    want, wstats = pm.run_epoch(stacked, pos, neg, pcfg)
    got, stats = pm.run_epoch(stacked, pos, neg, pcfg, touch_losses=False)
    assert stats.ent_loss is None and stats.rel_loss is None
    for name in ("ent", "rel"):
        assert torch.equal(got[name], want[name])
    for field in ("mean_loss", "ent_count", "rel_count"):
        assert torch.equal(getattr(stats, field), getattr(wstats, field))


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_batch_gradients_matches_reference(tables, norm):
    """BGD's Map: per-worker losses and gradients of one shared set of
    tables, against the reference's ``batch_gradients`` per worker."""
    rm, rp, pm, pp = _models(tables)
    rcfg, pcfg = _train_cfgs(norm)
    pos, neg = _batches((3,), 24, 5)
    losses, grads = pm.batch_gradients(pp, torch.tensor(pos),
                                       torch.tensor(neg), pcfg)
    assert grads["ent"].shape == (3, N_ENT, DIM)
    for w in range(3):
        want_loss, want = rm.batch_gradients(
            rp, jnp.asarray(pos[w]), jnp.asarray(neg[w]), rcfg)
        np.testing.assert_allclose(float(losses[w]), float(want_loss),
                                   **STEP_TOL)
        for name in ("ent", "rel"):
            np.testing.assert_allclose(grads[name][w].numpy(),
                                       np.asarray(want[name]),
                                       rtol=1e-4, atol=1e-5)


def test_run_epoch_options_not_ported(tables):
    """``run_epoch``'s options, all ported: ``update_mask`` needs the
    compact step (the reference's ``ValueError`` otherwise); with
    ``sparse_apply`` the masked epoch leaves frozen rows bitwise, in the
    projection too, and equals the reference's masked epoch within 1e-5,
    on one worker's batches and on stacked workers; ``sparse_apply``
    alone gives the dense epoch's bits."""
    rm, rp, pm, pp = _models(tables)
    rcfg, pcfg = _train_cfgs()
    pos, neg = _batches((2,), 8, 6)
    rng = np.random.default_rng(8)
    mask = {n: rng.random(len(p)) < 0.5 for n, p in pp.items()}
    tmask = {n: torch.as_tensor(m) for n, m in mask.items()}
    with pytest.raises(ValueError, match="requires sparse_apply=True") as e:
        pm.run_epoch(pp, torch.tensor(pos), torch.tensor(neg), pcfg,
                     update_mask=tmask)
    with pytest.raises(ValueError) as ref_e:
        rm.run_epoch(rp, jnp.asarray(pos), jnp.asarray(neg), rcfg,
                     update_mask={n: jnp.asarray(m)
                                  for n, m in mask.items()})
    assert str(e.value) == str(ref_e.value)
    want, _ = rm.run_epoch(rp, jnp.asarray(pos), jnp.asarray(neg), rcfg,
                           sparse_apply=True,
                           update_mask={n: jnp.asarray(m)
                                        for n, m in mask.items()})
    got, _ = pm.run_epoch(pp, torch.tensor(pos), torch.tensor(neg), pcfg,
                          sparse_apply=True, update_mask=tmask)
    stacked = {n: p.unsqueeze(0).repeat(2, 1, 1) for n, p in pp.items()}
    two, _ = pm.run_epoch(stacked, torch.tensor(np.stack([pos, pos])),
                          torch.tensor(np.stack([neg, neg])), pcfg,
                          sparse_apply=True, update_mask=tmask)
    for name in got:
        assert torch.equal(got[name][~tmask[name]], pp[name][~tmask[name]])
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   **STEP_TOL)
        assert not torch.equal(got[name][tmask[name]],
                               pp[name][tmask[name]])
        for w in range(2):
            assert torch.equal(two[name][w], got[name])
    pos, neg = (torch.tensor(a) for a in (pos, neg))
    dense, dense_stats = pm.run_epoch(pp, pos, neg, pcfg)
    sparse, sparse_stats = pm.run_epoch(pp, pos, neg, pcfg,
                                        sparse_apply=True)
    assert torch.equal(dense_stats.mean_loss, sparse_stats.mean_loss)
    for name in dense:
        assert torch.equal(dense[name], sparse[name])
