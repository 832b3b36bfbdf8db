"""``repro_torch.kernels.transe_score`` and the fused margin loss of
``repro_torch.kernels.ops`` against the Pallas kernel and the custom VJP
they replace.

On the CPU the wrappers run the kernels' plain versions
(``kernels/ref.transe_score_ref`` / ``transe_score_bwd_ref``), which do
the CUDA kernels' arithmetic operation for operation; the JAX side runs
the Pallas kernel in interpret mode, as the reference's own tests do.
Tolerances are the reference's (``tests/test_kernels_transe_score.py``):
rtol/atol 1e-5 for fp32 distances (the two packages sum the k terms of a
distance in different orders), 5e-2 for bf16 tables, and, for the
gradients, rtol 1e-4 / atol 1e-5 against ``jax.grad`` — the port's step
takes the kernel's closed-form gradient where the reference's takes
autodiff of ``margin_loss``.  The hinge ``(margin + d_pos) - d_neg``
subtracts two sums of magnitude ~100 at k = 64 whose last ulps differ
between the two orders, so its tolerance is 1e-5 of the sums it subtracts,
``1e-5 · (1 + d_pos + d_neg)``, not of its own value.

The kernels themselves run only on a card: see test_torch_kernels_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import transe as ref_transe
from repro.kernels import ops as ref_ops
from repro.kernels.transe_score import transe_score as pallas_transe_score
from repro_torch.core.models import get_model
from repro_torch.kernels import ops, transe_score
from repro_torch.util import ordered_index_add

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def make_inputs(E, R, k, B, seed=0):
    """The reference test's inputs: normal tables, uniform ids."""
    rng = np.random.default_rng(seed)
    ent = rng.normal(size=(E, k)).astype(np.float32)
    rel = rng.normal(size=(R, k)).astype(np.float32)
    idx = np.stack([rng.integers(0, E, B), rng.integers(0, R, B),
                    rng.integers(0, E, B), rng.integers(0, E, B),
                    rng.integers(0, E, B)], axis=1).astype(np.int32)
    return ent, rel, idx


def _port_fwd(ent, rel, idx, margin, norm, dtype=torch.float32):
    out = transe_score.transe_score(
        torch.tensor(ent).to(dtype), torch.tensor(rel).to(dtype),
        torch.tensor(idx), margin=margin, norm=norm)
    return [t.numpy() for t in out]


def _pallas_fwd(ent, rel, idx, margin, norm, dtype=jnp.float32):
    out = pallas_transe_score(
        jnp.asarray(ent).astype(dtype), jnp.asarray(rel).astype(dtype),
        jnp.asarray(idx), margin=margin, norm=norm, interpret=True)
    return [np.asarray(t) for t in out]


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("E,R,k,B", [
    (32, 4, 16, 8),
    (128, 8, 64, 32),
    (100, 3, 128, 17),    # non-power-of-2 table, odd batch
    (64, 2, 256, 1),      # single triplet
])
def test_plain_matches_pallas(E, R, k, B, norm):
    ent, rel, idx = make_inputs(E, R, k, B)
    launches = transe_score.transe_score.launches
    got = _port_fwd(ent, rel, idx, 1.0, norm)
    assert transe_score.transe_score.launches == launches  # plain version
    want = _pallas_fwd(ent, rel, idx, 1.0, norm)
    assert all(g.dtype == np.float32 and g.shape == (B,) for g in got)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **FWD_TOL)
    scale = 1.0 + want[1] + want[2]
    assert np.all(np.abs(got[0] - want[0]) <= 1e-5 * scale)


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_bf16_tables(norm):
    ent, rel, idx = make_inputs(64, 4, 32, 16)
    got = _port_fwd(ent, rel, idx, 2.0, norm, torch.bfloat16)
    want = _pallas_fwd(ent, rel, idx, 2.0, norm, jnp.bfloat16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_plain_equals_port_energy_bitwise(norm):
    """On fp32 tables the plain forward is bitwise the port's
    ``TransE.energy`` / ``per_pair_loss``: the same operations in the same
    order, which is what lets the kernel path and the plain path of the
    port agree exactly."""
    ent, rel, idx = make_inputs(80, 5, 50, 40, seed=1)
    params = {"ent": torch.tensor(ent), "rel": torch.tensor(rel)}
    pos = torch.tensor(idx[:, :3])
    neg = torch.tensor(idx[:, [3, 1, 4]])
    loss, d_pos, d_neg = transe_score.transe_score(
        params["ent"], params["rel"], torch.tensor(idx), margin=1.5,
        norm=norm)
    model = get_model("transe")
    assert torch.equal(d_pos, model.energy(params, pos, norm))
    assert torch.equal(d_neg, model.energy(params, neg, norm))
    assert torch.equal(loss, model.per_pair_loss(params, pos, neg,
                                                 margin=1.5, norm=norm))


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_stacked_workers_equal_per_worker_calls(norm):
    """Stacked ``(W, E, k)`` tables with ``(W, B, 5)`` ids, and one table
    shared through a worker-stride-0 view: each worker's outputs and
    gradient slice are bitwise those of a call on its own tables."""
    W, B = 3, 24
    tabs = [make_inputs(40, 6, 16, B, seed=w) for w in range(W)]
    ent = torch.tensor(np.stack([t[0] for t in tabs]))
    rel = torch.tensor(np.stack([t[1] for t in tabs]))
    idx = torch.tensor(np.stack([t[2] for t in tabs]))
    g = torch.full((W, B), 1.0 / B)
    for e, r in ((ent, rel), (ent[0].expand(W, 40, 16),
                              rel[0].expand(W, 6, 16))):
        fwd = transe_score.transe_score(e, r, idx, norm=norm)
        d_ent, d_rel = transe_score.transe_score_bwd(e, r, idx, g, *fwd,
                                                     norm=norm)
        assert d_ent.shape == (W, 40, 16) and d_rel.shape == (W, 6, 16)
        for w in range(W):
            one = transe_score.transe_score(e[w], r[w], idx[w], norm=norm)
            for a, b in zip(one, fwd):
                assert torch.equal(a, b[w])
            de, dr = transe_score.transe_score_bwd(e[w], r[w], idx[w], g[w],
                                                   *one, norm=norm)
            assert torch.equal(de, d_ent[w]) and torch.equal(dr, d_rel[w])


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_fused_gradient_matches_reference(norm):
    """grad(port fused loss) == grad(reference fused loss) ==
    grad(reference margin_loss), at the reference's gradient tolerance."""
    E, R, k, B = 40, 6, 16, 24
    ent, rel, idx = make_inputs(E, R, k, B, seed=7)
    pos, neg = idx[:, :3], np.stack([idx[:, 3], idx[:, 1], idx[:, 4]], 1)
    ref_params = {"ent": jnp.asarray(ent), "rel": jnp.asarray(rel)}
    g_fused = jax.grad(lambda p: ref_ops.transe_margin_loss(
        p, jnp.asarray(pos), jnp.asarray(neg), margin=1.0, norm=norm,
        interpret=True))(ref_params)
    g_auto = jax.grad(lambda p: ref_transe.margin_loss(
        p, jnp.asarray(pos), jnp.asarray(neg), margin=1.0,
        norm=norm))(ref_params)
    leaves = {"ent": torch.tensor(ent, requires_grad=True),
              "rel": torch.tensor(rel, requires_grad=True)}
    loss = ops.transe_margin_loss(leaves, torch.tensor(pos),
                                  torch.tensor(neg), margin=1.0, norm=norm)
    loss.backward()
    np.testing.assert_allclose(
        loss.item(), float(ref_transe.margin_loss(
            ref_params, jnp.asarray(pos), jnp.asarray(neg), margin=1.0,
            norm=norm)), **FWD_TOL)
    for name in ("ent", "rel"):
        got = leaves[name].grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g_fused[name]),
                                   **GRAD_TOL)
        np.testing.assert_allclose(got, np.asarray(g_auto[name]), **GRAD_TOL)


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_fused_gradient_matches_port_autograd(norm):
    """The closed form against torch autograd of the port's own
    ``margin_loss`` (port against port, same tolerance)."""
    ent, rel, idx = make_inputs(30, 4, 12, 50, seed=3)
    pos = torch.tensor(idx[:, :3])
    neg = torch.tensor(idx[:, [3, 1, 4]])
    model = get_model("transe")
    grads = []
    for loss_fn in (ops.transe_margin_loss, model.margin_loss):
        leaves = {"ent": torch.tensor(ent, requires_grad=True),
                  "rel": torch.tensor(rel, requires_grad=True)}
        loss_fn(leaves, pos, neg, margin=1.0, norm=norm).backward()
        grads.append({n: t.grad for n, t in leaves.items()})
    for name in ("ent", "rel"):
        torch.testing.assert_close(grads[0][name], grads[1][name],
                                   **GRAD_TOL)


def test_backward_zero_rows_and_dtype():
    """A row no triplet references gets exactly +0.0 (so ``p - lr·0 == p``
    bitwise); bf16 tables get bf16 gradients."""
    ent, rel, idx = make_inputs(50, 8, 8, 10, seed=2)
    idx[:, [0, 2, 3, 4]] %= 20           # rows 20.. never referenced
    idx[:, 1] %= 3
    for dtype in (torch.float32, torch.bfloat16):
        e, r = torch.tensor(ent).to(dtype), torch.tensor(rel).to(dtype)
        ix = torch.tensor(idx)
        fwd = transe_score.transe_score(e, r, ix, margin=4.0)
        d_ent, d_rel = transe_score.transe_score_bwd(
            e, r, ix, torch.full((10,), 0.1), *fwd)
        assert d_ent.dtype == d_rel.dtype == dtype
        for t, lo in ((d_ent, 20), (d_rel, 3)):
            tail = t[lo:].float()
            assert torch.equal(tail, torch.zeros_like(tail))
            assert not torch.signbit(tail).any()
        assert d_ent[:20].abs().sum() > 0


def test_ordered_index_add_is_a_sequential_scatter():
    """``ordered_index_add`` equals adding the contributions one at a time
    in list order, bitwise, rows repeated many times."""
    g = torch.Generator().manual_seed(0)
    rows = torch.randint(0, 7, (300,), generator=g)
    vals = torch.randn(300, 5, generator=g) * 1e3
    base = torch.randn(7, 5, generator=g)
    want = base.clone()
    for i in range(300):
        want[rows[i]] = want[rows[i]] + vals[i]
    got = ordered_index_add(base, rows, vals)
    assert torch.equal(got, want)
    assert torch.equal(ordered_index_add(base, rows[:0], vals[:0]), base)


def test_no_plain_version_off_the_cpu():
    """Tensors that are not all on the CPU never get the plain version:
    the wrappers raise unless they are all on one CUDA device."""
    ent, rel, idx = (torch.tensor(a) for a in make_inputs(10, 2, 4, 3))
    launches = (transe_score.transe_score.launches,
                transe_score.transe_score_bwd.launches)
    with pytest.raises(ValueError, match="CUDA"):
        transe_score.transe_score(ent.to("meta"), rel, idx)
    g = torch.ones(3)
    with pytest.raises(ValueError, match="CUDA"):
        transe_score.transe_score_bwd(ent, rel, idx.to("meta"), g, g, g, g)
    assert (transe_score.transe_score.launches,
            transe_score.transe_score_bwd.launches) == launches
