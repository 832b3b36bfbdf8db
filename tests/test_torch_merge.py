"""``repro_torch.core.merge`` (the dense stacked Reduce) against the
reference.  Averaging strategies are held at rtol/atol 1e-6 (sums over
four workers of values of magnitude ~1, which both packages take in
worker order, then one division); selection strategies pick whole rows,
so given the same stats and the same priorities (the reference's, replayed
from its ``jax.random`` key) they must be equal exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import merge as ref_merge
from repro_torch.core import merge as port_merge

W, N, K = 4, 60, 8


@pytest.fixture(scope="module")
def inputs():
    """Stacked tables and stats in which some keys were touched by no
    worker, some by one, some by several."""
    rng = np.random.default_rng(0)
    stacked = rng.normal(size=(W, N, K)).astype(np.float32)
    counts = rng.integers(0, 4, size=(W, N)).astype(np.float32)
    counts[:, :5] = 0                          # touched by nobody
    counts[0, 5:10], counts[1:, 5:10] = 2, 0   # by worker 0 alone
    losses = (counts * rng.uniform(0.1, 2.0, size=(W, N))).astype(np.float32)
    worker_loss = rng.uniform(0.5, 1.5, size=(W,)).astype(np.float32)
    return stacked, counts, losses, worker_loss


@pytest.mark.parametrize("strategy", port_merge.STRATEGIES)
def test_merge_stacked_matches_reference(inputs, strategy):
    assert port_merge.STRATEGIES == ref_merge.STRATEGIES
    key = jax.random.PRNGKey(3)
    want = np.asarray(ref_merge.merge_stacked(
        strategy, *(jnp.asarray(a) for a in inputs), key))
    priorities = torch.tensor(np.asarray(
        ref_merge._random_priorities(key, W, N)))
    got = port_merge.merge_stacked(
        strategy, *(torch.tensor(a) for a in inputs),
        priorities=priorities).numpy()
    assert got.shape == (N, K)
    if strategy.startswith("average"):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_selections_pick_touching_workers(inputs):
    """Keys only worker 0 touched come from worker 0 under the touch-aware
    selections; ``miniloss_global`` takes every row from the worker with the
    smallest loss."""
    stacked, counts, losses, worker_loss = (torch.tensor(a) for a in inputs)
    pri = port_merge.random_priorities(torch.Generator().manual_seed(0),
                                       W, N, "cpu")
    for strategy in ("random", "miniloss_perkey"):
        got = port_merge.merge_stacked(strategy, stacked, counts, losses,
                                       worker_loss, priorities=pri)
        assert torch.equal(got[5:10], stacked[0, 5:10])
    best = int(torch.argmin(worker_loss))
    assert torch.equal(port_merge.merge_stacked(
        "miniloss_global", stacked, counts, losses, worker_loss),
        stacked[best])


def test_worker_sum_is_in_worker_order():
    """((1e8 + 1) - 1e8) + 1 in float32: the first 1 is absorbed."""
    x = torch.tensor([[1e8], [1.0], [-1e8], [1.0]])
    assert float(port_merge.worker_sum(x)) == 1.0
    assert float(port_merge.worker_mean(x)) == 0.25


def test_merge_stacked_rejects(inputs):
    args = [torch.tensor(a) for a in inputs]
    with pytest.raises(ValueError, match="priorities"):
        port_merge.merge_stacked("random", *args)
    with pytest.raises(ValueError, match="unknown strategy"):
        port_merge.merge_stacked("median", *args)
