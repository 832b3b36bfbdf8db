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


def _plain_sum_bound(abs_dot, k):
    """``γ_k · Σ|q_j e_j|``, ``γ_k = k·u / (1 - k·u)``, ``u = 2⁻²⁴``: the
    most an in-order fp32 sum of ``k`` rounded products can differ from
    the exact dot product."""
    u = 2.0 ** -24
    return k * u / (1 - k * u) * abs_dot


def _in_order_dot(q, e):
    """``Σ_j q_j·e_j`` in fp32 over the last axis, j in order, one rounding
    per operation: the plain version's ``qe``."""
    acc = q[..., 0] * e[..., 0]
    for j in range(1, q.shape[-1]):
        acc = acc + q[..., j] * e[..., j]
    return acc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 7, 50, 64, 129, 256])
@pytest.mark.parametrize("spread", ["normal", "wide"])
def test_l2_screen_margin_covers_the_plain_sum(k, dtype, spread):
    """The plain version's in-order fp32 ``qe`` stays within the standard
    bound ``γ_k·Σ|q_j e_j|`` of the exact dot product, and that bound
    within the L2 screen's margin ``l2_screen_margin``: the margin's share
    for the plain sum holds.  ``wide`` mixes magnitudes over 2**±20, so
    terms cancel."""
    rng = np.random.default_rng(k)
    shape = (4000, k)
    q, e = rng.normal(size=shape), rng.normal(size=shape)
    if spread == "wide":
        q *= 2.0 ** rng.integers(-20, 21, size=shape)
        e *= 2.0 ** rng.integers(-20, 21, size=shape)
    q32 = torch.tensor(q, dtype=torch.float32).to(getattr(torch, dtype))
    e32 = torch.tensor(e, dtype=torch.float32).to(getattr(torch, dtype))
    q32, e32 = q32.float(), e32.float()          # the kernel's fp32 values
    plain = _in_order_dot(q32, e32).double()
    q64, e64 = q32.double(), e32.double()
    exact = (q64 * e64).sum(-1)
    err = (plain - exact).abs()
    share = _plain_sum_bound((q64 * e64).abs().sum(-1), k)
    margin = rank_topk.l2_screen_margin(_in_order_dot(q32, q32),
                                        _in_order_dot(e32, e32), k)
    assert torch.all(err <= share)
    assert torch.all(share <= margin)
    if k > 1 or dtype == "float32":        # bf16 products are exact
        assert float(err.max()) > 0        # the sums did round


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_l2_epilogue_is_monotone(seed):
    """The plain L2 decision ``l2_distance(qq, x, ee) < gold`` never goes
    from true back to false as ``x`` (the dot product) steps through
    adjacent fp32 values, with ``qq``, ``ee`` and ``gold`` fixed: the
    premise of the kernel's screen, which decides a pair from ``x ± δ``."""
    rng = np.random.default_rng(seed)
    qq, ee = (torch.tensor(v, dtype=torch.float32)
              for v in rng.uniform(1.0, 30.0, size=2))
    x0 = rng.uniform(-float(qq + ee), float(qq + ee)) / 2
    gold = port_ref.l2_distance(qq, torch.tensor(x0, dtype=torch.float32), ee)
    # 40,001 adjacent floats centred on x0, where the decision flips
    x = torch.tensor([x0], dtype=torch.float32)
    steps = torch.arange(-20000, 20001, dtype=torch.int64)
    sign = -1 if x0 < 0 else 1          # bit patterns order by magnitude
    bits = x.view(torch.int32).to(torch.int64) + sign * steps
    xs = bits.to(torch.int32).view(torch.float32)
    assert torch.all(xs[1:] > xs[:-1])              # adjacent, ascending
    decided = port_ref.l2_distance(qq, xs, ee) < gold
    flips = decided[1:].int() - decided[:-1].int()
    assert torch.all(flips >= 0)
    assert decided[0].item() is False and decided[-1].item() is True
    # gold sits at x0's own distance, so x0 itself does not count
    assert not bool(port_ref.l2_distance(qq, xs[20000], ee) < gold)
