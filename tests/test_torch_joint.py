"""Joint negatives (``KGConfig(negatives="joint")``, DGL-KE's shared
candidate pool) in ``repro_torch.core.models`` against the reference, for
the three registered models.

Tolerances: the closed forms against the generic substitution at the
reference's own rtol 1e-4, atol 1e-5; steps, epochs and gradients at 1e-5
as in ``tests/test_torch_models.py``; the pool's ids exactly; the generic
diagonal bitwise.  Stacked workers are held bitwise against per-worker
runs: each worker scores its own positives against its own pool.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.models import get_model as ref_get_model
from repro.core.models.base import KGConfig as RefKGConfig
from repro_torch.core import models as port_models
from repro_torch.kernels import transe_score as ts

from test_torch_models_family import (
    DIM, N_ENT, N_REL, _batches, _pair, ref_model_tables)

MODELS = ("transe", "transh", "distmult")
NORMS = ("l1", "l2")
STEP_TOL = dict(rtol=1e-5, atol=1e-5)
CLOSED_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def tables():
    return {name: ref_model_tables(name) for name in MODELS}


def _cfgs(norm="l1", neg_candidates=0, normalize="epoch"):
    kw = dict(dim=DIM, margin=1.0, norm=norm, learning_rate=0.05,
              normalize=normalize, negatives="joint",
              neg_candidates=neg_candidates)
    return RefKGConfig(N_ENT, N_REL, **kw), port_models.KGConfig(
        N_ENT, N_REL, **kw)


def _colliding_batches(lead, B, seed):
    """Batches whose pools hold many positives' gold entities (few distinct
    entities), so the validity mask removes candidates unevenly."""
    rng = np.random.default_rng(seed)
    shape = lead + (B,)
    pos = np.stack([rng.integers(0, 6, shape), rng.integers(0, N_REL, shape),
                    rng.integers(0, 6, shape)], -1)
    neg = pos.copy()
    side = np.where(rng.random(shape) < 0.5, 0, 2)
    np.put_along_axis(neg, side[..., None],
                      rng.integers(0, 6, shape)[..., None], -1)
    return pos.astype(np.int32), neg.astype(np.int32)


@pytest.mark.parametrize("n_candidates", [0, 5, 64])
def test_joint_parts_ids_exact(n_candidates):
    pos, neg = _batches((), 24, 11)
    rm, pm = ref_get_model("transe"), port_models.get_model("transe")
    want_cand, want_side = rm.joint_parts(jnp.asarray(pos), jnp.asarray(neg),
                                          n_candidates)
    cand, side = pm.joint_parts(torch.tensor(pos), torch.tensor(neg),
                                n_candidates)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want_cand))
    np.testing.assert_array_equal(side.numpy(), np.asarray(want_side))
    assert cand.shape == (min(n_candidates or 24, 24),)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_generic_joint_diagonal_is_energy_of_neg(tables, name, norm):
    """With the full pool (C = B), entry (b, b) of the generic joint
    matrix is the energy of positive b's own corruption, bitwise."""
    _, _, pm, pp = _pair(tables, name)
    pos, neg = (torch.tensor(a) for a in _batches((), 32, 12))
    cand, side = pm.joint_parts(pos, neg, 0)
    generic = port_models.KGModel.joint_energies(pm, pp, pos, cand, side,
                                                 norm)
    assert generic.shape == (32, 32)
    assert torch.equal(torch.diagonal(generic), pm.energy(pp, neg, norm))


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_closed_forms_match_generic_and_reference(tables, name, norm):
    """Each model's closed ``joint_energies`` against the port's generic
    substitution (the reference's tolerance) and against the reference's
    closed form, at a pool cut to C = 9."""
    rm, rp, pm, pp = _pair(tables, name)
    pos, neg = _batches((), 32, 13)
    cand, side = pm.joint_parts(torch.tensor(pos), torch.tensor(neg), 9)
    closed = pm.joint_energies(pp, torch.tensor(pos), cand, side, norm)
    generic = port_models.KGModel.joint_energies(
        pm, pp, torch.tensor(pos), cand, side, norm)
    assert closed.shape == (32, 9)
    np.testing.assert_allclose(closed.numpy(), generic.numpy(), **CLOSED_TOL)
    want = rm.joint_energies(rp, jnp.asarray(pos), jnp.asarray(cand.numpy()),
                             jnp.asarray(side.numpy()), norm)
    np.testing.assert_allclose(closed.numpy(), np.asarray(want),
                               **CLOSED_TOL)


def test_joint_hinges_mask_the_gold(tables):
    """A candidate equal to a positive's gold entity on its corrupted side
    is invalid and its hinge is 0; every other entry is the hinge."""
    _, _, pm, pp = _pair(tables, "transe")
    pos, neg = (torch.tensor(a) for a in _colliding_batches((), 40, 14))
    hinges, valid = pm.joint_hinges(pp, pos, neg, margin=1.0, norm="l1")
    cand, side = pm.joint_parts(pos, neg, 0)
    gold = torch.where(side, pos[:, 0], pos[:, 2])
    collide = cand[None, :] == gold[:, None]
    assert 0 < int(collide.sum()) < collide.numel()
    assert torch.equal(valid, (~collide).float())
    assert torch.all(hinges[collide] == 0)
    d_pos = pm.energy(pp, pos, "l1")
    d_cand = pm.joint_energies(pp, pos, cand, side, "l1")
    full = torch.clamp_min((1.0 + d_pos[:, None]) - d_cand, 0.0)
    assert torch.equal(hinges[~collide], full[~collide])


@pytest.mark.parametrize("n_candidates", [0, 3, 1000])
def test_neg_candidates_caps_the_pool(tables, n_candidates):
    _, _, pm, pp = _pair(tables, "distmult")
    pos, neg = (torch.tensor(a) for a in _batches((2,), 16, 15))
    hinges, valid = pm.joint_hinges(pp, pos, neg, margin=1.0, norm="l1",
                                    n_candidates=n_candidates)
    C = 16 if n_candidates in (0, 1000) else n_candidates
    assert hinges.shape == valid.shape == (2, 16, C)


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_joint_sgd_step_matches_reference(tables, name, norm):
    rm, rp, pm, pp = _pair(tables, name)
    rcfg, pcfg = _cfgs(norm, neg_candidates=12, normalize="step")
    pos, neg = _colliding_batches((), 32, 16)
    want, want_loss = rm.sgd_step(rp, jnp.asarray(pos), jnp.asarray(neg),
                                  rcfg)
    got, loss = pm.sgd_step(pp, torch.tensor(pos), torch.tensor(neg), pcfg)
    np.testing.assert_allclose(float(loss), float(want_loss), **STEP_TOL)
    for table in pp:
        np.testing.assert_allclose(got[table].numpy(),
                                   np.asarray(want[table]), **STEP_TOL)


def test_step_loss_is_joint_margin_loss_not_mean_of_pairs(tables):
    """The joint step's loss (and so its gradient) is ``Σ hinges /
    max(Σ valid, 1)``, which differs from the mean of the per-positive
    ``joint_pair_loss`` when positives keep unequal numbers of valid
    candidates; the epoch's mean loss is the mean of the step losses."""
    rm, rp, pm, pp = _pair(tables, "transe")
    _, pcfg = _cfgs("l1", normalize="none")
    pos, neg = (torch.tensor(a) for a in _colliding_batches((), 40, 17))
    margin = pm.joint_margin_loss(pp, pos, neg, margin=1.0, norm="l1")
    pairs = pm.joint_pair_loss(pp, pos, neg, margin=1.0, norm="l1")
    assert abs(float(margin) - float(pairs.mean())) > 1e-3
    _, loss = pm.sgd_step(pp, pos, neg, pcfg)
    assert torch.equal(loss, margin)
    np.testing.assert_allclose(
        float(margin), float(rm.joint_margin_loss(
            rp, jnp.asarray(pos.numpy()), jnp.asarray(neg.numpy()),
            margin=1.0, norm="l1")), **STEP_TOL)
    # the gradient is that of the margin loss
    leaves = {n: p.clone().requires_grad_() for n, p in pp.items()}
    pm.joint_margin_loss(leaves, pos, neg, margin=1.0, norm="l1").backward()
    _, _, grads = pm._pairs_and_grads(pp, pos, neg, pcfg)
    for n in pp:
        assert torch.equal(grads[n], leaves[n].grad)
    _, stats = pm.run_epoch(pp, pos[None], neg[None], pcfg)
    assert torch.equal(stats.mean_loss, margin)


@pytest.mark.parametrize("name,norm", [("transe", "l2"), ("transh", "l1"),
                                       ("distmult", "l1")])
def test_joint_run_epoch_matches_reference(tables, name, norm):
    rm, rp, pm, pp = _pair(tables, name)
    rcfg, pcfg = _cfgs(norm, neg_candidates=8)
    pos, neg = _colliding_batches((4,), 32, 18)
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


@pytest.mark.parametrize("W", [2, 3])
@pytest.mark.parametrize("name", MODELS)
def test_joint_stacked_workers_equal_separate_runs(tables, name, W):
    """Stacked workers each score their own batch against their own pool:
    an epoch of W stacked workers equals W separate epochs bitwise, and
    BGD's per-worker gradients of the shared tables equal each worker's
    own."""
    _, _, pm, pp = _pair(tables, name)
    _, pcfg = _cfgs("l2", neg_candidates=6)
    pos, neg = (torch.tensor(a) for a in _colliding_batches((W, 3), 16, 19))
    stacked = {n: p.unsqueeze(0).repeat(W, 1, 1) for n, p in pp.items()}
    got, stats = pm.run_epoch(stacked, pos, neg, pcfg)
    losses, grads = pm.batch_gradients(pp, pos[:, 0], neg[:, 0], pcfg)
    for w in range(W):
        one, ostats = pm.run_epoch(pp, pos[w], neg[w], pcfg)
        for table in pp:
            assert torch.equal(got[table][w], one[table])
        for field in ("mean_loss", "ent_count", "ent_loss", "rel_count",
                      "rel_loss"):
            assert torch.equal(getattr(stats, field)[w],
                               getattr(ostats, field))
        loss, grad = pm.batch_gradients(pp, pos[w, 0], neg[w, 0], pcfg)
        assert torch.equal(losses[w], loss)
        for table in pp:
            assert torch.equal(grads[table][w], grad[table])


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name", MODELS)
def test_joint_batch_gradients_match_reference(tables, name, norm):
    rm, rp, pm, pp = _pair(tables, name)
    rcfg, pcfg = _cfgs(norm)
    pos, neg = _colliding_batches((3,), 24, 20)
    losses, grads = pm.batch_gradients(pp, torch.tensor(pos),
                                       torch.tensor(neg), pcfg)
    for w in range(3):
        want_loss, want = rm.batch_gradients(
            rp, jnp.asarray(pos[w]), jnp.asarray(neg[w]), rcfg)
        np.testing.assert_allclose(float(losses[w]), float(want_loss),
                                   **STEP_TOL)
        for table in pp:
            np.testing.assert_allclose(grads[table][w].numpy(),
                                       np.asarray(want[table]), **STEP_TOL)


def test_joint_transe_step_launches_no_transe_score(tables, monkeypatch):
    """The joint objective is plain PyTorch, as the reference's is plain
    jnp: a joint TransE step never calls the ``transe_score`` wrappers,
    while a per-triplet step calls each once."""
    calls = {"fwd": 0, "bwd": 0}

    def counting(fn, key):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(ts, "transe_score", counting(ts.transe_score, "fwd"))
    monkeypatch.setattr(ts, "transe_score_bwd",
                        counting(ts.transe_score_bwd, "bwd"))
    _, _, pm, pp = _pair(tables, "transe")
    pos, neg = (torch.tensor(a) for a in _batches((2,), 16, 21))
    joint = port_models.KGConfig(N_ENT, N_REL, dim=DIM, negatives="joint")
    stacked = {n: p.unsqueeze(0).repeat(2, 1, 1) for n, p in pp.items()}
    pm.sgd_step(stacked, pos, neg, joint)
    pm.batch_gradients(pp, pos, neg, joint)
    assert calls == {"fwd": 0, "bwd": 0}
    pm.sgd_step(stacked, pos, neg,
                port_models.KGConfig(N_ENT, N_REL, dim=DIM))
    assert calls == {"fwd": 1, "bwd": 1}
