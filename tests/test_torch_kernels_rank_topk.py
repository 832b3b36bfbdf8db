"""``repro_torch.kernels.rank_topk`` against the Pallas kernel it replaces.

On the CPU the wrapper runs the kernel's plain version
(``kernels/ref.rank_counts_ref``), which does the CUDA kernel's
arithmetic operation for operation; the JAX side runs the Pallas kernel
in interpret mode, as the reference's own tests do.  fp32 counts must be
equal.  Where a fixed-seed case flips a count, the check below requires
an entity whose exact (float64) distance lies within 4 ulps of the gold
for every flipped count: the two packages sum in different orders, so
such a near-tie may land on either side, and nothing else may differ.

The kernel itself runs only on a card: see test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.rank_topk import rank_counts as pallas_rank_counts
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels import rank_topk


def make(B, E, k, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, k)).astype(np.float32)
    tab = rng.normal(size=(E, k)).astype(np.float32)
    gold = rng.uniform(0.5, 4.0, size=(B,)).astype(np.float32)
    return q, tab, gold


def port_counts(q, tab, gold, norm, dtype=torch.float32):
    return rank_topk.rank_counts(
        torch.tensor(q).to(dtype), torch.tensor(tab).to(dtype),
        torch.tensor(gold), norm=norm).numpy()


def pallas_counts(q, tab, gold, norm, **tiles):
    return np.asarray(pallas_rank_counts(
        jnp.asarray(q), jnp.asarray(tab), jnp.asarray(gold), norm=norm,
        interpret=True, **tiles))


def assert_equal_up_to_near_ties(got, want, q, tab, gold, norm):
    """``got == want``, except that a count may differ by at most the
    number of entities within 4 ulps of the gold distance (exact float64
    distances)."""
    for b in np.flatnonzero(got != want):
        diff = q[b].astype(np.float64)[None, :] - tab.astype(np.float64)
        d = (np.abs(diff).sum(1) if norm == "l1"
             else np.sqrt((diff * diff).sum(1)))
        near = np.abs(d - gold[b]) <= 4 * np.spacing(np.float32(gold[b]))
        assert abs(int(got[b]) - int(want[b])) <= int(near.sum()), (
            f"query {b}: count {got[b]} vs {want[b]} with only "
            f"{int(near.sum())} entities within 4 ulps of the gold")


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize(
    "B,E,k,tb,te",
    [
        (8, 64, 16, 8, 16),
        (17, 100, 32, 8, 32),      # paddings on both axes
        (4, 1000, 64, 4, 128),     # many entity tiles
        (33, 50, 8, 16, 64),       # te > E
    ],
)
def test_plain_matches_pallas(B, E, k, tb, te, norm):
    q, tab, gold = make(B, E, k)
    got = port_counts(q, tab, gold, norm)
    want = pallas_counts(q, tab, gold, norm, tb=tb, te=te)
    assert got.dtype == np.int32 and got.shape == (B,)
    assert_equal_up_to_near_ties(got, want, q, tab, gold, norm)


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("seed", [0, 7, 123, 2**31 - 1])
def test_count_bounds_fixed_seeds(seed, norm):
    q, tab, gold = make(9, 70, 12, seed=seed)
    got = port_counts(q, tab, gold, norm)
    assert np.all(got >= 0) and np.all(got <= 70)
    want = pallas_counts(q, tab, gold, norm, tb=4, te=16)
    assert_equal_up_to_near_ties(got, want, q, tab, gold, norm)


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("k", [16, 50])
def test_gold_at_a_table_row(norm, k):
    """Gold distances as evaluation makes them — the distance to one
    table row — so counts spread over the whole table, at the slice's
    width k = 50 as well."""
    B, E = 24, 600
    q, tab, _ = make(B, E, k, seed=4)
    gold_rows = np.random.default_rng(5).integers(0, E, B)
    diff = q - tab[gold_rows]
    gold = (np.abs(diff).sum(1) if norm == "l1"
            else np.sqrt((diff * diff).sum(1))).astype(np.float32)
    got = port_counts(q, tab, gold, norm)
    want = pallas_counts(q, tab, gold, norm, tb=8, te=128)
    assert 0 < got.mean() < E
    assert_equal_up_to_near_ties(got, want, q, tab, gold, norm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_sweep(dtype):
    q, tab, gold = make(12, 128, 16)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    got = port_counts(q, tab, gold, "l2", dtype=getattr(torch, dtype))
    want = np.asarray(jax_ref.rank_counts_ref(
        jnp.asarray(q).astype(jdt), jnp.asarray(tab).astype(jdt),
        jnp.asarray(gold), "l2"))
    # bf16 may flip counts for near-threshold entities: the reference's
    # own slack for its kernel (tests/test_kernels_rank_topk.py)
    tol = 0 if dtype == "float32" else 3
    assert np.all(np.abs(got - want) <= tol)


def test_l2_clamp_follows_pallas_not_jax_ref():
    """An entity equal to its query: ``qq - 2·qe + ee`` rounds below zero
    for about half of the rows at this scale.  The Pallas kernel and the
    port clamp it to 0 and count the entity (distance 1e-6 < gold); the
    JAX oracle ``ref.rank_counts_ref`` has no clamp, takes the root of a
    negative number and never counts the NaN."""
    rng = np.random.default_rng(0)
    q = (100.0 * rng.normal(size=(32, 16))).astype(np.float32)
    gold = np.ones(32, np.float32)      # far below any other distance
    got = port_counts(q, q, gold, "l2")
    want = pallas_counts(q, q, gold, "l2", tb=8, te=16)
    unclamped = np.asarray(jax_ref.rank_counts_ref(
        jnp.asarray(q), jnp.asarray(q), jnp.asarray(gold), "l2"))
    np.testing.assert_array_equal(got, np.ones(32, np.int32))
    np.testing.assert_array_equal(got, want)
    assert 0 < int((unclamped == 0).sum()) < 32


def test_plain_version_chunks_the_table(monkeypatch):
    """The plain version walks the table in chunks; the chunking changes
    no count."""
    q, tab, gold = make(6, 300, 8, seed=2)
    gold = gold * 4
    whole = port_counts(q, tab, gold, "l1")
    monkeypatch.setattr(port_ref, "_CHUNK_ELEMS", 6 * 7)   # 7-row chunks
    np.testing.assert_array_equal(port_counts(q, tab, gold, "l1"), whole)


def test_no_plain_version_off_the_cpu():
    """Tensors that are not all on the CPU never get the plain version:
    the wrapper raises unless they are all on one CUDA device."""
    q, tab, gold = make(4, 10, 8)
    launches = rank_topk.rank_counts.launches
    with pytest.raises(ValueError, match="CUDA"):
        rank_topk.rank_counts(torch.tensor(q, device="meta"),
                              torch.tensor(tab), torch.tensor(gold))
    assert rank_topk.rank_counts.launches == launches
