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
    assert port_models.available() == ("transe",)
    with pytest.raises(NotImplementedError, match="not ported"):
        port_models.get_model("distmult")
    with pytest.raises(ValueError, match="unknown KG model"):
        port_models.get_model("rotate")
    with pytest.raises(ValueError, match="norm"):
        port_models.dissimilarity(torch.ones(2, 3), "l3")
