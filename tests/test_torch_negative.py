"""``repro_torch.core.negative`` against the reference: ``bernoulli_stats``
is numpy in both packages and must be equal exactly; the corruptions are
equal exactly given the reference's own draws, replayed here from its
``jax.random`` keys (``repro/core/negative.py``: per batch one key, split
into the side draw and the offset draw)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import negative as ref_negative
from repro.data import kg as ref_kg_lib
from repro_torch.core import negative as port_negative

from test_torch_parity_helpers import TINY_KG


@pytest.fixture(scope="module")
def graph():
    return ref_kg_lib.synthetic_kg(0, **TINY_KG)


def _replayed_draws(key, lead, B, E):
    """The reference's ``make_negatives`` draws for batches of leading
    shape ``lead``: ``(uniform, offset)`` of shape ``lead + (B,)``."""
    keys = jax.random.split(key, int(np.prod(lead)))
    us, offs = [], []
    for k in keys:
        k_side, k_ent = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(k_side, (B,))))
        offs.append(np.asarray(jax.random.randint(k_ent, (B,), 1, E)))
    return (np.stack(us).reshape(lead + (B,)),
            np.stack(offs).reshape(lead + (B,)))


@pytest.mark.parametrize("n_relations", [6, 9])
def test_bernoulli_stats_exact(graph, n_relations):
    """Includes relations without triplets (n_relations past the graph's):
    they get 0.5."""
    want = ref_negative.bernoulli_stats(graph.train, n_relations)
    got = port_negative.bernoulli_stats(graph.train, n_relations)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(
        port_negative.bernoulli_stats(graph.train[:0], 3),
        ref_negative.bernoulli_stats(graph.train[:0], 3))


def test_corrupt_bern_injected_draws(graph):
    key = jax.random.PRNGKey(4)
    E = graph.n_entities
    probs = ref_negative.bernoulli_stats(graph.train, graph.n_relations)
    trip = graph.train[:200]
    want = np.asarray(ref_negative.corrupt_bern(
        key, jnp.asarray(trip), E, jnp.asarray(probs)))
    k_side, k_ent = jax.random.split(key)
    u = np.asarray(jax.random.uniform(k_side, (len(trip),)))
    off = np.asarray(jax.random.randint(k_ent, (len(trip),), 1, E))
    got = port_negative.corrupt_bern(
        torch.tensor(trip), E, torch.tensor(probs),
        uniform=torch.tensor(u), offset=torch.tensor(off))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
@pytest.mark.parametrize("sampling", ["unif", "bern"])
def test_make_negatives_injected_draws(graph, lead, sampling):
    """``(S, B, 3)`` and ``(W, S, B, 3)`` batches, both samplers."""
    B, E = 40, graph.n_entities
    n = int(np.prod(lead)) * B
    pos = graph.train[:n].reshape(lead + (B, 3))
    probs = ref_negative.bernoulli_stats(graph.train, graph.n_relations)
    key = jax.random.PRNGKey(9)
    want = np.asarray(ref_negative.make_negatives(
        key, jnp.asarray(pos), E, sampling, jnp.asarray(probs)))
    u, off = _replayed_draws(key, lead, B, E)
    got = port_negative.make_negatives(
        torch.tensor(pos), E, sampling, torch.tensor(probs),
        uniform=torch.tensor(u), offset=torch.tensor(off))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_make_negatives_port_draws(graph):
    """The port's own draws: seeded, one side changed per triplet, the
    relation kept; a 'bern' run without probabilities is refused."""
    pos = torch.tensor(graph.train[:300].reshape(2, 3, 50, 3))
    E = graph.n_entities
    a = port_negative.make_negatives(
        pos, E, generator=torch.Generator().manual_seed(1))
    b = port_negative.make_negatives(
        pos, E, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    changed = (a[..., 0] != pos[..., 0]).int() + (a[..., 2] != pos[..., 2])
    assert torch.equal(changed, torch.ones_like(changed))
    assert torch.equal(a[..., 1], pos[..., 1])
    with pytest.raises(ValueError, match="head_prob_per_rel"):
        port_negative.make_negatives(pos, E, "bern")
    with pytest.raises(ValueError, match="unknown sampling"):
        port_negative.make_negatives(pos, E, "zipf")
