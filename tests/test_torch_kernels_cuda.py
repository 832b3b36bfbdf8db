"""The port's CUDA kernels against their plain versions, on a card.

Each test is marked ``cuda`` and skips without a CUDA device (a kernel has
no CPU mode).  The file imports neither jax nor the reference, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py
"""
import contextlib
import datetime

import pytest
import torch
import torch.distributed as dist

from repro_torch import kg
from repro_torch.core import eval_device, keys, mapreduce, negative
from repro_torch.core.models import KGConfig, get_model
from repro_torch.data import kg as kg_data
from repro_torch.kernels import ref, rank_topk, transe_score


@pytest.fixture
def cuda():
    """The card, with TF32 matmuls off for the test (restored after)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("B,E,k", [
    (256, 14951, 50),      # the evaluation chunk at FB15k size
    (70, 1000, 7),         # ragged query and table tiles, odd k
    (3, 129, 256),         # the widest k: 6 L1 / 5 L2 column chunks
    (5, 300, 1),           # k = 1
    (1, 14951, 50),        # one query
    (256, 100, 64),        # a table smaller than one tile
    (129, 129, 129),       # one query and one row past a tile
    (600, 20000, 50),      # 128-query tiles, several per block
])
def test_rank_counts_matches_plain(cuda, B, E, k, norm, dtype):
    """Equal counts, not close ones: under L1 the kernel and its plain
    version do the same fp32 operations in the same order; under L2 the
    kernel's tensor-core screen re-checks in that order every pair it
    cannot decide.  Shapes on every edge of the tiling."""
    g = torch.Generator(device=cuda).manual_seed(B * E + k)
    q = torch.randn(B, k, generator=g, device=cuda).to(dtype)
    tab = torch.randn(E, k, generator=g, device=cuda).to(dtype)
    rows = torch.randint(0, E, (B,), generator=g, device=cuda)
    diff = q.float() - tab[rows].float()
    gold = (diff.abs().sum(1) if norm == "l1"
            else diff.square().sum(1).sqrt()).contiguous()
    launches = rank_topk.rank_counts.launches
    got = rank_topk.rank_counts(q, tab, gold, norm=norm)
    torch.cuda.synchronize()
    assert rank_topk.rank_counts.launches == launches + 1
    want = ref.rank_counts_ref(q, tab, gold, norm)
    assert 0 < float(want.float().mean()) < E
    assert torch.equal(got, want)


def _tie_stress(dev, B, E, k, norm, dtype, copies=8):
    """Each query's gold row copied into ``copies`` other table rows, half
    exactly and half one ulp off in one coordinate, and the gold distance
    computed by the plain version's own arithmetic: pairs at, or one ulp
    from, the threshold."""
    g = torch.Generator(device=dev).manual_seed(B + k)
    q = torch.randn(B, k, generator=g, device=dev).to(dtype)
    tab = torch.randn(E, k, generator=g, device=dev).to(dtype)
    perm = torch.randperm(E, generator=g, device=dev)
    golds, slots = perm[:B], perm[B:B * (copies + 1)].view(B, copies)
    rows = tab[golds][:, None, :].repeat(1, copies, 1)
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    col = torch.randint(0, k, (B, copies // 2, 1), generator=g, device=dev)
    off = rows[:, copies // 2:, :]
    bits = off.gather(2, col).view(ints)
    step = torch.where(torch.rand(bits.shape, generator=g, device=dev) < 0.5,
                       1, -1).to(ints)
    off.scatter_(2, col, (bits + step).view(dtype))
    tab[slots.reshape(-1)] = rows.reshape(-1, k)
    qf, gf = q.float(), tab[golds].float()
    if norm == "l1":
        gold = (qf[:, 0] - gf[:, 0]).abs()
        for j in range(1, k):
            gold = gold + (qf[:, j] - gf[:, j]).abs()
    else:
        qq, qe, ee = qf[:, 0] * qf[:, 0], qf[:, 0] * gf[:, 0], \
            gf[:, 0] * gf[:, 0]
        for j in range(1, k):
            qq = qq + qf[:, j] * qf[:, j]
            qe = qe + qf[:, j] * gf[:, j]
            ee = ee + gf[:, j] * gf[:, j]
        gold = ref.l2_distance(qq, qe, ee)
    return q, tab, gold.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_rank_counts_at_ties(cuda, norm, dtype):
    """Counts hang on single ulps (planted exact and one-ulp copies of each
    gold row): still the plain version's, and under L2 the screen sends
    pairs to the in-order re-check (counted by ``recheck_counter``)."""
    q, tab, gold = _tie_stress(cuda, 200, 5000, 50, norm, dtype)
    rechecked = torch.zeros(1, dtype=torch.int64, device=cuda)
    got = rank_topk.rank_counts(q, tab, gold, norm=norm,
                                recheck_counter=rechecked)
    want = ref.rank_counts_ref(q, tab, gold, norm)
    assert torch.equal(got, want)
    if norm == "l2":
        assert int(rechecked) > 0
    else:
        assert int(rechecked) == 0


@pytest.mark.cuda
def test_rank_counts_rejects_what_it_does_not_take(cuda):
    q = torch.zeros(4, 8, device=cuda)
    tab = torch.zeros(10, 8, device=cuda)
    gold = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="CPU"):
        rank_topk.rank_counts(q, tab.cpu(), gold)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        rank_topk.rank_counts(q.half(), tab.half(), gold)
    with pytest.raises(ValueError, match="contiguous"):
        rank_topk.rank_counts(q, tab.t().contiguous().t(), gold)


@pytest.mark.cuda
def test_device_eval_through_the_kernel(cuda):
    """On CUDA tables the device engine ranks through the kernel by
    default; under L1 its raw ranks equal the plain-scorer path's."""
    graph = kg_data.synthetic_kg(0, n_entities=500, n_relations=8,
                                 n_triplets=4000)
    params = get_model("transe").init_params(
        torch.Generator().manual_seed(0),
        KGConfig(graph.n_entities, graph.n_relations, dim=50), device=cuda)
    masks = graph.eval_filter_candidates()
    launches = rank_topk.rank_counts.launches
    fused = eval_device.entity_ranks_device(params, graph.test, "l1", masks)
    assert rank_topk.rank_counts.launches > launches
    plain = eval_device.entity_ranks_device(params, graph.test, "l1", masks,
                                            fused=False)
    for side in ("tail", "head"):
        assert (fused["raw_ranks"][side] == plain["raw_ranks"][side]).all()


def _transe_inputs(dev, W, B, E, R, k, dtype, seed, hot=0):
    """Stacked ``(W, E, k)`` tables (``W = 0``: unstacked) and ``(W, B, 5)``
    ids; ``hot > 0`` draws entity ids from the first ``hot`` rows only, so
    each of those rows collects many contributions (the scatter's hard
    case)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lead = (W,) if W else ()
    ent = torch.randn(*lead, E, k, generator=g, device=dev).to(dtype)
    rel = torch.randn(*lead, R, k, generator=g, device=dev).to(dtype)
    hi = hot or E
    cols = [torch.randint(0, n, (*lead, B), generator=g, device=dev)
            for n in (hi, R, hi, hi, hi)]
    idx = torch.stack(cols, dim=-1).to(torch.int32).contiguous()
    return ent, rel, idx


def _assert_bitwise(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16 if a.element_size() == 2
                                  else torch.int32),
                           b.view(torch.int16 if b.element_size() == 2
                                  else torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("W,B,E,R,k,hot", [
    (0, 77, 1000, 13, 50, 0),       # ragged batch (not a multiple of 32)
    (0, 1, 64, 3, 7, 0),            # one triplet, k = 7
    (0, 40, 300, 5, 256, 0),        # the widest k
    (0, 500, 400, 4, 50, 3),        # three hot rows: long scatter runs
    (4, 256, 2000, 30, 50, 0),      # stacked workers, the main path's shape
    (4, 1027, 3000, 20, 50, 0),     # many tiles, a ragged last one
    (0, 300, 500, 7, 1, 0),         # k = 1: one-element loads
    (0, 300, 500, 7, 33, 0),        # k = 33: odd, scalar loads
    (0, 65536, 5000, 1, 50, 0),     # one relation row takes every triplet
])
def test_transe_score_matches_plain(cuda, W, B, E, R, k, hot, norm, dtype):
    """Forward and backward equal their plain versions bitwise: the same
    fp32 operations in the same order, each row's scatter summed in the
    order of ``ref.scatter_rows``; two backward runs give the same bits."""
    ent, rel, idx = _transe_inputs(cuda, W, B, E, R, k, dtype, B + E + k,
                                   hot)
    before = (transe_score.transe_score.launches,
              transe_score.transe_score_bwd.launches)
    fwd = transe_score.transe_score(ent, rel, idx, margin=2.0, norm=norm)
    if B > 1:                       # both active and inactive hinges
        assert 0.2 < float((fwd[0] > 0).float().mean()) < 1
    g = torch.full(idx.shape[:-1], 1.0 / B, device=cuda)
    bwd = transe_score.transe_score_bwd(ent, rel, idx, g, *fwd, norm=norm)
    again = transe_score.transe_score_bwd(ent, rel, idx, g, *fwd, norm=norm)
    torch.cuda.synchronize()
    assert (transe_score.transe_score.launches,
            transe_score.transe_score_bwd.launches) == (
                before[0] + 1, before[1] + 2)
    _assert_bitwise(fwd, ref.transe_score_ref(ent, rel, idx, 2.0, norm))
    _assert_bitwise(bwd, ref.transe_score_bwd_ref(ent, rel, idx, g, *fwd,
                                                  norm))
    _assert_bitwise(bwd, again)


@pytest.mark.cuda
def test_transe_score_bwd_writes_every_row(cuda):
    """The backward writes every row of its gradients, +0.0 where no
    triplet references one: memory the allocator hands back full of NaN
    does not show through."""
    ent, rel, idx = _transe_inputs(cuda, 2, 8, 3000, 40, 16, torch.float32,
                                   9)
    fwd = transe_score.transe_score(ent, rel, idx, norm="l1")
    g = torch.full(idx.shape[:-1], 1.0 / 8, device=cuda)
    want = ref.transe_score_bwd_ref(ent, rel, idx, g, *fwd, "l1")
    torch.cuda.synchronize()
    poison = [torch.full_like(t, float("nan")) for t in want]
    del poison                      # the blocks go back to the allocator
    got = transe_score.transe_score_bwd(ent, rel, idx, g, *fwd)
    _assert_bitwise(got, want)
    assert int((got[0] != 0).any(-1).sum()) <= 2 * 8 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_transe_score_bwd_back_to_back_batches(cuda, norm):
    """Two different batches' backwards, one right after the other, each
    equal their plain versions: the second may be handed the first's freed
    per-triplet scratch and must not read anything the first left there."""
    batches = [_transe_inputs(cuda, 0, B, 900, 11, 50, torch.float32, seed)
               for B, seed in ((700, 1), (300, 2))]
    plain = []
    for ent, rel, idx in batches:
        fwd = transe_score.transe_score(ent, rel, idx, margin=2.0, norm=norm)
        g = torch.full(idx.shape[:-1], 1.0 / idx.shape[0], device=cuda)
        plain.append((fwd, g, ref.transe_score_bwd_ref(ent, rel, idx, g,
                                                       *fwd, norm)))
    torch.cuda.synchronize()
    got = [transe_score.transe_score_bwd(ent, rel, idx, g, *fwd, norm=norm)
           for (ent, rel, idx), (fwd, g, _) in zip(batches, plain)]
    for out, (_, _, want) in zip(got, plain):
        _assert_bitwise(out, want)


@pytest.mark.cuda
def test_transe_score_shared_table_per_worker_grads(cuda):
    """A table expanded over workers with stride 0 (BGD) is read by every
    worker and gives each worker's gradient in its own slice."""
    ent, rel, idx = _transe_inputs(cuda, 3, 64, 200, 6, 16, torch.float32, 5)
    ent, rel = ent[0], rel[0]
    wide = (ent.expand(3, *ent.shape), rel.expand(3, *rel.shape))
    fwd = transe_score.transe_score(*wide, idx, norm="l1")
    g = torch.full(idx.shape[:-1], 1.0 / 64, device=cuda)
    d_ent, d_rel = transe_score.transe_score_bwd(*wide, idx, g, *fwd)
    for w in range(3):
        one = transe_score.transe_score(ent, rel, idx[w], norm="l1")
        _assert_bitwise(one, [t[w] for t in fwd])
        _assert_bitwise(transe_score.transe_score_bwd(
            ent, rel, idx[w], g[w], *one), (d_ent[w], d_rel[w]))


@pytest.mark.cuda
def test_transe_score_rejects_what_it_does_not_take(cuda):
    ent, rel, idx = _transe_inputs(cuda, 0, 8, 20, 4, 8, torch.float32, 1)
    with pytest.raises(ValueError, match="CPU"):
        transe_score.transe_score(ent, rel.cpu(), idx)
    with pytest.raises(TypeError, match="int32"):
        transe_score.transe_score(ent, rel, idx.long())
    with pytest.raises(IndexError, match="outside"):
        transe_score.transe_score(ent, rel, idx * 10)
    with pytest.raises(ValueError, match="k in"):
        wide = torch.zeros(20, 257, device=cuda)
        transe_score.transe_score(wide, torch.zeros(4, 257, device=cuda),
                                  idx)


class _NoHostSync:
    """``torch.cuda.set_sync_debug_mode("error")`` for a ``with`` block:
    any call that waits for the card, a device→host copy among them,
    raises."""

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        return False


@pytest.mark.cuda
@pytest.mark.parametrize("W", [0, 4])
def test_transe_score_without_id_checks_makes_no_host_sync(cuda, W):
    """By default both wrappers raise on an id outside its table; with
    ``check_ids=False`` neither makes a device→host copy, and they give the
    bits of the checked calls."""
    ent, rel, idx = _transe_inputs(cuda, W, 256, 2000, 30, 50,
                                   torch.float32, 4)
    bad = idx.clone()
    bad[..., 0, 3] = ent.shape[-2]
    with pytest.raises(IndexError, match="outside"):
        transe_score.transe_score(ent, rel, bad)
    fwd = transe_score.transe_score(ent, rel, idx)
    g = torch.full(idx.shape[:-1], 1.0 / 256, device=cuda)
    with pytest.raises(IndexError, match="outside"):
        transe_score.transe_score_bwd(ent, rel, bad, g, *fwd)
    bwd = transe_score.transe_score_bwd(ent, rel, idx, g, *fwd)
    with _NoHostSync():
        fwd_off = transe_score.transe_score(ent, rel, idx, check_ids=False)
        bwd_off = transe_score.transe_score_bwd(ent, rel, idx, g, *fwd_off,
                                                check_ids=False)
    _assert_bitwise(fwd_off, fwd)
    _assert_bitwise(bwd_off, bwd)


@pytest.mark.cuda
def test_counter_draws_equal_cpu(cuda):
    """The device pipeline's draws give the CPU's bits on the card."""
    k = keys.fold_in(keys.device_keys(7)[1], torch.arange(4))
    for fn in (lambda d: keys.random_bits(k.to(d), 1 << 16, d),
               lambda d: keys.uniform(k.to(d), 1 << 16, d),
               lambda d: keys.randint(k.to(d), 1 << 16, 1, 14951, d),
               lambda d: keys.permutation(k.to(d), 1 << 16, d),
               lambda d: negative.device_draws(k.to(d), (4, 64, 256),
                                               14951, d)[1]):
        assert torch.equal(fn(cuda).cpu(), fn("cpu"))
    part = torch.as_tensor(kg_data.partition_balanced(
        0, kg_data.synthetic_kg(0, 400, 8, 5000).train, 4))
    for r in (0, 3):
        assert torch.equal(
            kg_data.device_repartition(11, part.to(cuda), r).cpu(),
            kg_data.device_repartition(11, part, r))
    assert torch.equal(
        kg_data.device_epoch_batches(5, part.to(cuda), 128).cpu(),
        kg_data.device_epoch_batches(5, part, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("paradigm,opts", [
    ("sgd", dict(merge_every=2, repartition_every=2, block_epochs=2)),
    ("bgd", dict(repartition_every=2, partition="degree", block_epochs=2)),
])
def test_device_block_makes_no_host_sync(cuda, paradigm, opts):
    """A device-pipeline block on the card makes no host sync, launches
    both kernels once a step, and gives the CPU block's bits."""
    graph = kg_data.synthetic_kg(0, n_entities=400, n_relations=8,
                                 n_triplets=5000)
    kcfg, mcfg = kg.make_configs(graph, "transe", paradigm, dim=32,
                                 batch_size=128, pipeline="device", **opts)
    part = kg_data.PARTITIONERS[mcfg.partition](0, graph.train, 4)
    strata = None
    if mcfg.partition == "degree":
        strata = torch.as_tensor(kg_data.triplet_strata(
            part.reshape(-1, 3), graph.n_entities))
    init = get_model("transe").init_params(
        torch.Generator().manual_seed(0), kcfg, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        block_fn = mapreduce.make_block_fn(
            mcfg, kcfg, torch.as_tensor(part, device=dev), seed=3,
            strata=None if strata is None else strata.to(dev))
        params = {n: t.to(dev) for n, t in init.items()}
        before = (transe_score.transe_score.launches,
                  transe_score.transe_score_bwd.launches)
        if dev == "cpu":
            out[dev] = block_fn(params, range(2, 4))
            continue
        with _NoHostSync():
            out[dev] = block_fn(params, range(2, 4))
        steps = 2 * (part.shape[1] // 128)
        assert (transe_score.transe_score.launches - before[0],
                transe_score.transe_score_bwd.launches - before[1]) == (
                    steps, steps)
    (p_cpu, l_cpu), (p_card, l_card) = out["cpu"], out[cuda]
    assert torch.equal(l_card.cpu(), l_cpu)
    for name in p_cpu:
        assert torch.equal(p_card[name].cpu(), p_cpu[name])


@pytest.mark.cuda
@pytest.mark.parametrize("paradigm", ["sgd", "bgd"])
def test_fit_trains_through_the_kernels(cuda, paradigm):
    """``kg.fit`` on the card goes through both kernels, once per step each
    (all workers in one launch), and matches the CPU run of the same draws:
    the CPU takes the plain versions, whose scatter sums agree bitwise but
    whose norms, means and merges run PyTorch's CPU reductions, so the two
    agree to float32 rounding, 1e-5."""
    graph = kg_data.synthetic_kg(0, n_entities=400, n_relations=8,
                                 n_triplets=5000)
    kw = dict(dim=32, batch_size=128, n_workers=4, epochs=2, seed=3)
    before = (transe_score.transe_score.launches,
              transe_score.transe_score_bwd.launches)
    card = kg.fit(graph, paradigm=paradigm, **kw)
    steps = 2 * (len(graph.train) // 4 // 128)
    assert (transe_score.transe_score.launches - before[0],
            transe_score.transe_score_bwd.launches - before[1]) == (
                steps, steps)
    host = kg.fit(graph, paradigm=paradigm, device="cpu", **kw)
    assert card.kb.params["ent"].is_cuda
    for name in host.params:
        torch.testing.assert_close(card.params[name].cpu(),
                                   host.params[name], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.tensor(card.loss_history),
                               torch.tensor(host.loss_history),
                               rtol=1e-5, atol=1e-5)
    again = kg.fit(graph, paradigm=paradigm, **kw)
    for name in card.params:
        assert torch.equal(card.params[name], again.params[name])
    assert card.loss_history == again.loss_history


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", ["epoch", "step"])
@pytest.mark.parametrize("model_name", ["transe", "transh", "distmult"])
def test_compact_step_matches_dense_step_on_the_card(cuda, model_name,
                                                     normalize):
    """The sparse transport's compact SGD step gives the dense step's bits
    on the card, for one table set and for stacked per-worker tables; for
    TransE both go through the ``transe_score`` kernels, the compact step
    on ``(W, 4B, k)`` / ``(W, 2B, k)`` tables."""
    model = get_model(model_name)
    E, R, B = 3000, 300, 64
    kcfg = KGConfig(E, R, dim=32, learning_rate=0.05, normalize=normalize)
    params = model.init_params(torch.Generator().manual_seed(1), kcfg,
                               device=cuda)
    stacked = {n: t.unsqueeze(0).repeat(4, 1, 1) + 0.01 * torch.arange(
        4.0, device=cuda)[:, None, None] for n, t in params.items()}
    g = torch.Generator(device=cuda).manual_seed(5)
    for p, lead in ((params, (B,)), (stacked, (4, B))):
        pos, neg = (torch.stack([
            torch.randint(0, n, lead, generator=g, device=cuda)
            for n in (E, R, E)], dim=-1) for _ in range(2))
        before = transe_score.transe_score.launches
        dense_p, dense_l = model.sgd_step(p, pos, neg, kcfg)
        sparse_p, sparse_l = model.sgd_step_sparse(p, pos, neg, kcfg)
        torch.cuda.synchronize()
        if model_name == "transe":
            assert transe_score.transe_score.launches == before + 2
        assert torch.equal(dense_l.view(torch.int32),
                           sparse_l.view(torch.int32))
        for name in dense_p:
            assert torch.equal(dense_p[name].view(torch.int32),
                               sparse_p[name].view(torch.int32)), name


@pytest.mark.cuda
@pytest.mark.parametrize("paradigm,opts", [
    ("sgd", dict(merge_every=2, repartition_every=2, block_epochs=2)),
    ("sgd", dict(strategy="random", block_epochs=2)),
    ("bgd", dict(block_epochs=2)),
])
def test_sparse_block_makes_no_host_sync(cuda, paradigm, opts):
    """A sparse-transport block on the card makes no host sync, launches
    both kernels once a step, and gives the dense block's bits; its
    overflow is a device scalar, 0."""
    graph = kg_data.synthetic_kg(0, n_entities=4000, n_relations=300,
                                 n_triplets=5000)
    part = torch.as_tensor(kg_data.PARTITIONERS["balanced"](
        0, graph.train, 4), device=cuda)
    out = {}
    for transport in ("dense", "sparse"):
        kcfg, mcfg = kg.make_configs(
            graph, "transe", paradigm, dim=32, batch_size=128,
            pipeline="device", merge_transport=transport, **opts)
        init = get_model("transe").init_params(
            torch.Generator().manual_seed(0), kcfg, device=cuda)
        block_fn = mapreduce.make_block_fn(mcfg, kcfg, part, seed=3,
                                           with_overflow=True)
        before = (transe_score.transe_score.launches,
                  transe_score.transe_score_bwd.launches)
        with _NoHostSync():
            out[transport] = block_fn(init, range(2))
        steps = 2 * (part.shape[1] // 128)
        assert (transe_score.transe_score.launches - before[0],
                transe_score.transe_score_bwd.launches - before[1]) == (
                    steps, steps)
    (p_d, l_d, _), (p_s, l_s, ovf) = out["dense"], out["sparse"]
    assert ovf.is_cuda and int(ovf) == 0
    assert torch.equal(l_d, l_s)
    for name in p_d:
        assert torch.equal(p_d[name].view(torch.int32),
                           p_s[name].view(torch.int32)), name


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["dense", "sparse"])
def test_stale_block_makes_no_host_sync(cuda, transport):
    """A bounded-staleness block on the card (state ``(global_view,
    worker_locals)``) makes no host sync, launches both kernels once a
    step, and gives the CPU block's bits."""
    graph = kg_data.synthetic_kg(0, n_entities=400, n_relations=8,
                                 n_triplets=5000)
    kcfg, mcfg = kg.make_configs(graph, "transe", "sgd", dim=32,
                                 batch_size=128, pipeline="device",
                                 staleness=1, merge_transport=transport)
    part = kg_data.PARTITIONERS["balanced"](0, graph.train, 4)
    init = get_model("transe").init_params(
        torch.Generator().manual_seed(0), kcfg, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        block_fn = mapreduce.make_block_fn(
            mcfg, kcfg, torch.as_tensor(part, device=dev), seed=3,
            with_overflow=True)
        g = {n: t.to(dev) for n, t in init.items()}
        state = (g, mapreduce._broadcast(g, 4))
        if dev == "cpu":
            out[dev] = block_fn(state, range(4))
            continue
        before = (transe_score.transe_score.launches,
                  transe_score.transe_score_bwd.launches)
        with _NoHostSync():
            out[dev] = block_fn(state, range(4))
        steps = 4 * (part.shape[1] // 128)
        assert (transe_score.transe_score.launches - before[0],
                transe_score.transe_score_bwd.launches - before[1]) == (
                    steps, steps)
    ((g_cpu, l_cpu), loss_cpu, _), ((g_card, l_card), loss_card, ovf) = (
        out["cpu"], out[cuda])
    assert int(ovf) == 0
    assert torch.equal(loss_card.cpu(), loss_cpu)
    for name in g_cpu:
        assert torch.equal(g_card[name].cpu(), g_cpu[name])
        assert torch.equal(l_card[name].cpu(), l_cpu[name])


@pytest.mark.cuda
def test_sharded_sparse_reduce_makes_no_host_sync(cuda):
    """The shard-routed sparse Reduce (and its stale form) on the card
    makes no host sync and gives the replicated merge's bits."""
    from repro_torch.core import merge

    gen = torch.Generator().manual_seed(0)
    W, N, k, cap = 4, 1001, 16, 300
    stacked = torch.randn(W, N, k, generator=gen).to(cuda)
    counts = (torch.rand(W, N, generator=gen) < 0.2).float().to(cuda)
    losses = torch.rand(W, N, generator=gen).to(cuda) * counts
    wl = torch.rand(W, generator=gen).to(cuda)
    base = torch.randn(N, k, generator=gen).to(cuda)
    pri = torch.rand(W, N, generator=gen).to(cuda)
    fn = get_model("transe").normalize_rows
    with _NoHostSync():
        idx, vals, cnt, lss = merge.pack_delta(stacked, counts, losses, cap,
                                               N)
        got = {s: merge.merge_sparse_sharded_stacked(
                   s, idx, vals, cnt, lss, wl, stacked[0], base,
                   lambda r: fn("ent", r), 1, pri, n_shards=W)
               for s in merge.STRATEGIES}
        stale = {s: merge.merge_sparse_stale_sharded_stacked(
                     s, idx, vals, cnt, lss, wl, base, pri, n_shards=W)
                 for s in merge.STRATEGIES}
    for s in merge.STRATEGIES:
        assert torch.equal(got[s], merge.merge_sparse_stacked(
            s, idx, vals, cnt, lss, wl, stacked[0], base,
            lambda r: fn("ent", r), 1, pri))
        assert torch.equal(stale[s], merge.merge_sparse_stale(
            s, idx, vals, cnt, lss, wl, base, pri))


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_transh_step_cpu_equals_card(cuda, norm):
    """A TransH step (autograd of the in-order scorer, the hyperplane
    projection's broadcasts through ``base.spread_last``) gives the same
    bits on the CPU and on the card."""
    graph = kg_data.synthetic_kg(0, n_entities=400, n_relations=8,
                                 n_triplets=5000)
    kcfg, _ = kg.make_configs(graph, "transh", "sgd", dim=32, norm=norm)
    model = get_model("transh")
    params = model.init_params(torch.Generator().manual_seed(0), kcfg,
                               device="cpu")
    gen = torch.Generator().manual_seed(1)
    pos = torch.stack([torch.randint(0, 400, (4, 128), generator=gen),
                       torch.randint(0, 8, (4, 128), generator=gen),
                       torch.randint(0, 400, (4, 128), generator=gen)], -1)
    neg = pos.clone()
    neg[..., 2] = torch.randint(0, 400, (4, 128), generator=gen)
    stacked = mapreduce._broadcast(params, 4)
    out = {}
    for dev in ("cpu", cuda):
        p = {n: t.to(dev) for n, t in stacked.items()}
        out[dev] = model.sgd_step(p, pos.to(dev), neg.to(dev), kcfg)
    (p_cpu, l_cpu), (p_card, l_card) = out["cpu"], out[cuda]
    assert torch.equal(l_card.cpu(), l_cpu)
    for name in p_cpu:
        assert torch.equal(p_card[name].cpu(), p_cpu[name]), name


def _half_mask(n, seed):
    return torch.rand(n, generator=torch.Generator().manual_seed(seed)) < 0.5


@pytest.mark.cuda
def test_masked_block_makes_no_host_sync(cuda):
    """A masked fine-tune block (``make_block_fn(update_mask=...)``, the
    sparse transport) on the card makes no host sync, launches both
    kernels once a step, keeps frozen rows bitwise and gives the CPU
    block's bits."""
    graph = kg_data.synthetic_kg(0, n_entities=400, n_relations=8,
                                 n_triplets=5000)
    kcfg, mcfg = kg.make_configs(graph, "transe", "sgd", dim=32,
                                 batch_size=128, pipeline="device",
                                 merge_transport="sparse")
    part = kg_data.PARTITIONERS["balanced"](0, graph.train, 4)
    init = get_model("transe").init_params(
        torch.Generator().manual_seed(0), kcfg, device="cpu")
    mask = {"ent": _half_mask(400, 1), "rel": _half_mask(8, 2)}
    out = {}
    for dev in ("cpu", cuda):
        block_fn = mapreduce.make_block_fn(
            mcfg, kcfg, torch.as_tensor(part, device=dev), seed=3,
            with_overflow=True, update_mask=mask)
        params = {n: t.to(dev) for n, t in init.items()}
        if dev == "cpu":
            out[dev] = block_fn(params, range(2))
            continue
        before = (transe_score.transe_score.launches,
                  transe_score.transe_score_bwd.launches)
        with _NoHostSync():
            out[dev] = block_fn(params, range(2))
        steps = 2 * (part.shape[1] // 128)
        assert (transe_score.transe_score.launches - before[0],
                transe_score.transe_score_bwd.launches - before[1]) == (
                    steps, steps)
    (p_cpu, loss_cpu, _), (p_card, loss_card, ovf) = out["cpu"], out[cuda]
    assert int(ovf) == 0
    assert torch.equal(loss_card.cpu(), loss_cpu)
    for name in p_cpu:
        assert torch.equal(p_card[name].cpu(), p_cpu[name]), name
        frozen = ~mask[name]
        assert torch.equal(p_cpu[name][frozen], init[name][frozen])
        assert not torch.equal(p_cpu[name][~frozen], init[name][~frozen])


@pytest.mark.cuda
@pytest.mark.parametrize("normalize", ["epoch", "step"])
def test_masked_compact_step_cpu_equals_card(cuda, normalize):
    """A masked compact TransE step of 4 stacked workers (the kernels,
    then the mask's gather and ``where``) gives the same bits on the CPU
    and on the card, frozen rows unchanged."""
    graph = kg_data.synthetic_kg(0, n_entities=400, n_relations=8,
                                 n_triplets=5000)
    kcfg, _ = kg.make_configs(graph, "transe", "sgd", dim=32,
                              normalize=normalize)
    model = get_model("transe")
    params = mapreduce._broadcast(model.init_params(
        torch.Generator().manual_seed(0), kcfg, device="cpu"), 4)
    gen = torch.Generator().manual_seed(1)
    pos = torch.stack([torch.randint(0, 400, (4, 128), generator=gen),
                       torch.randint(0, 8, (4, 128), generator=gen),
                       torch.randint(0, 400, (4, 128), generator=gen)], -1)
    neg = pos.clone()
    neg[..., 2] = torch.randint(0, 400, (4, 128), generator=gen)
    mask = {"ent": _half_mask(400, 3), "rel": _half_mask(8, 4)}
    out = {}
    for dev in ("cpu", cuda):
        p = {n: t.to(dev) for n, t in params.items()}
        m = {n: t.to(dev) for n, t in mask.items()}
        out[dev] = model.sgd_step_sparse(p, pos.to(dev), neg.to(dev), kcfg,
                                         update_mask=m)
    (p_cpu, l_cpu), (p_card, l_card) = out["cpu"], out[cuda]
    assert torch.equal(l_card.cpu(), l_cpu)
    for name in p_cpu:
        assert torch.equal(p_card[name].cpu(), p_cpu[name]), name
        assert torch.equal(p_cpu[name][:, ~mask[name]],
                           params[name][:, ~mask[name]])


@pytest.mark.cuda
def test_update_on_card_keeps_frozen_rows(cuda, tmp_path):
    """``kb.update`` of an artifact on the card runs there: frozen rows
    bitwise the base's, the same bits as the update of the same artifact
    on the CPU, and a chain of it reloads on the card to its
    fingerprint."""
    from repro_torch.kb import KnowledgeBase
    from repro_torch.online import OnlineUpdater

    graph = kg_data.synthetic_kg(0, n_entities=400, n_relations=8,
                                 n_triplets=5000)
    base = kg.fit(graph, epochs=2, dim=32, batch_size=128, n_workers=4,
                  pipeline="device", device=cuda).kb
    rng = torch.Generator().manual_seed(5)
    delta = torch.stack([torch.randint(0, 420, (300,), generator=rng),
                         torch.randint(0, 8, (300,), generator=rng),
                         torch.randint(0, 400, (300,), generator=rng)],
                        1).numpy()
    chain = str(tmp_path / "chain")
    kb_card = base.update(delta, epochs=2, seed=3, delta_dir=chain)
    on_cpu = KnowledgeBase(base.model, {n: t.cpu() for n, t in
                                        base.params.items()},
                           graph=base.graph, norm=base.norm)
    kb_cpu = on_cpu.update(delta, epochs=2, seed=3)
    plan = OnlineUpdater(base, epochs=2, seed=3).plan(delta)
    for name, table in kb_card.params.items():
        assert table.device.type == "cuda"
        assert torch.equal(table.cpu(), kb_cpu.params[name]), name
        n = base.params[name].shape[0]
        frozen = torch.as_tensor(~plan.update_mask[name][:n], device=cuda)
        assert torch.equal(table[:n][frozen], base.params[name][frozen])
    assert kb_card.fingerprint() == kb_cpu.fingerprint()
    re = KnowledgeBase.load_chain(chain, device=cuda)
    assert re.fingerprint() == kb_card.fingerprint()


@contextlib.contextmanager
def _nccl_mesh(tmp_path):
    """A one-rank NCCL process group (a ``FileStore`` under ``tmp_path``)
    and its ``"workers"`` mesh on the card, torn down on exit."""
    from repro_torch.parallel import util as par

    dist.init_process_group(
        "nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        yield par.workers_mesh(1, "cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("paradigm,opts", [
    ("sgd", dict(reduce_impl="allgather")),
    ("sgd", dict(reduce_impl="psum", strategy="random")),
    ("sgd", dict(merge_transport="sparse", strategy="miniloss_perkey")),
    ("bgd", {}),
    ("bgd", dict(merge_transport="sparse")),
    ("sgd", dict(pipeline="device", merge_every=2, repartition_every=2,
                 block_epochs=2)),
    ("sgd", dict(pipeline="device", merge_every=2, repartition_every=2,
                 block_epochs=2, merge_transport="sparse")),
])
def test_shard_map_one_rank_is_vmap_bitwise(cuda, tmp_path, paradigm, opts):
    """The shard_map backend over a one-rank NCCL mesh on the card gives
    the vmap backend's bits (the psum Reduce too, at M = 1), and its
    evaluation and top-k the vmap engine's."""
    graph = kg_data.synthetic_kg(0, n_entities=2000, n_relations=40,
                                 n_triplets=12000)
    kw = dict(dim=32, batch_size=128, n_workers=4, epochs=2, seed=0,
              device=cuda, **opts)
    want = kg.fit(graph, "transe", paradigm, **kw)
    with _nccl_mesh(tmp_path) as mesh:
        got = kg.fit(graph, "transe", paradigm, backend="shard_map",
                     mesh=mesh, **kw)
        for name in want.params:
            assert torch.equal(got.params[name].view(torch.int32),
                               want.params[name].view(torch.int32)), name
        assert got.loss_history == want.loss_history
        assert kg.evaluate(want.kb, engine="device", backend="shard_map",
                           mesh=mesh, n_workers=4) == kg.evaluate(
                               want.kb, engine="device")
        pairs = graph.test[:300]
        a = want.kb.query_tails(pairs[:, 0], pairs[:, 1], k=10,
                                filtered=True, backend="shard_map",
                                mesh=mesh, n_workers=4)
        b = want.kb.query_tails(pairs[:, 0], pairs[:, 1], k=10,
                                filtered=True)
        assert (a.ids == b.ids).all()
        assert a.energies.tobytes() == b.energies.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("transport", ["dense", "sparse"])
def test_shard_map_block_makes_no_host_sync(cuda, tmp_path, transport):
    """A device-pipeline block over a one-rank NCCL mesh makes no host
    sync (its collectives are NCCL's, which make none) and gives the vmap
    block's bits."""
    graph = kg_data.synthetic_kg(0, n_entities=4000, n_relations=300,
                                 n_triplets=5000)
    part = torch.as_tensor(kg_data.PARTITIONERS["balanced"](
        0, graph.train, 4), device=cuda)
    out = {}
    with _nccl_mesh(tmp_path) as mesh:
        for backend in ("vmap", "shard_map"):
            kcfg, mcfg = kg.make_configs(
                graph, "transe", "sgd", dim=32, batch_size=128,
                pipeline="device", merge_transport=transport,
                reduce_impl="allgather", merge_every=2, repartition_every=2,
                block_epochs=2, backend=backend)
            init = get_model("transe").init_params(
                torch.Generator().manual_seed(0), kcfg, device=cuda)
            block_fn = mapreduce.make_block_fn(
                mcfg, kcfg, part, seed=3, with_overflow=True,
                mesh=mesh if backend == "shard_map" else None)
            block_fn(dict(init), range(2))          # communicators, caches
            torch.cuda.synchronize()
            with _NoHostSync():
                out[backend] = block_fn(dict(init), range(2, 4))
    (p_v, l_v, _), (p_s, l_s, ovf) = out["vmap"], out["shard_map"]
    assert int(ovf) == 0 and torch.equal(l_v, l_s)
    for name in p_v:
        assert torch.equal(p_v[name].view(torch.int32),
                           p_s[name].view(torch.int32)), name


@pytest.mark.cuda
def test_shard_map_stale_sharded_block_makes_no_host_sync(cuda, tmp_path):
    """A bounded-staleness (S = 2) block of sparse SGD with sharded tables
    over a one-rank NCCL mesh, its global view taken and returned at rest,
    makes no host sync once the communicators exist, launches both
    kernels once a step, and gives the CPU vmap block's bits."""
    from repro_torch.parallel import sharding

    graph = kg_data.synthetic_kg(0, n_entities=400, n_relations=8,
                                 n_triplets=5000)
    part = kg_data.PARTITIONERS["balanced"](0, graph.train, 4)
    out = {}
    with _nccl_mesh(tmp_path) as mesh:
        for backend, dev in (("vmap", torch.device("cpu")),
                             ("shard_map", cuda)):
            kcfg, mcfg = kg.make_configs(
                graph, "transe", "sgd", dim=32, batch_size=128,
                pipeline="device", staleness=2, merge_every=2,
                block_epochs=4, merge_transport="sparse",
                table_sharding="sharded", backend=backend)
            init = get_model("transe").init_params(
                torch.Generator().manual_seed(0), kcfg, device=dev)
            on_mesh = mesh if backend == "shard_map" else None
            g = dict(init)
            if on_mesh is not None:
                layout = mapreduce.resting_layout(mcfg, kcfg,
                                                  get_model("transe"))
                assert layout == {"ent": "row", "rel": "whole"}
                g = sharding.place(g, layout, 4, on_mesh)
            block_fn = mapreduce.make_block_fn(
                mcfg, kcfg, torch.as_tensor(part, device=dev), seed=3,
                with_overflow=True, mesh=on_mesh)
            state, *_ = block_fn((g, mapreduce._broadcast(init, 4)),
                                 range(4))     # communicators, caches
            if on_mesh is None:
                out[backend] = block_fn(state, range(4, 8))
                continue
            torch.cuda.synchronize()
            before = (transe_score.transe_score.launches,
                      transe_score.transe_score_bwd.launches)
            with _NoHostSync():
                out[backend] = block_fn(state, range(4, 8))
            steps = 4 * (part.shape[1] // 128)
            assert (transe_score.transe_score.launches - before[0],
                    transe_score.transe_score_bwd.launches - before[1]) == (
                        steps, steps)
    ((g_cpu, l_cpu), loss_cpu, _), ((g_card, l_card), loss_card, ovf) = (
        out["vmap"], out["shard_map"])
    assert int(ovf) == 0
    assert torch.equal(loss_card.cpu(), loss_cpu)
    for name in g_cpu:
        assert torch.equal(g_card[name].cpu(), g_cpu[name]), name
        assert torch.equal(l_card[name].cpu(), l_cpu[name]), name


# ---------------------------------------------------------------------------
# LM serving (no kernel lies on it): the card against the port's own
# teacher-forced forward, against the CPU, and rerun
# ---------------------------------------------------------------------------

LM_ARCHS = ["smollm-135m", "gemma2-2b", "gemma2-9b", "qwen3-4b",
            "llava-next-mistral-7b"]


def _lm_run(task, model, toks, Lp, steps, patch):
    """Prefill ``toks[:, :Lp]`` then decode the rest of ``toks`` one by
    one: every call's logits, (B, steps + 1, V) on the CPU."""
    from repro_torch.models import registry   # noqa: F401 (the task's)

    n_vis = 0 if patch is None else patch.shape[1]
    batch = {"tokens": toks[:, :Lp]}
    if patch is not None:
        batch["patch_embeds"] = patch
    caches, logits = task.prefill(model, batch)
    out = [logits[:, 0]]
    for t in range(steps):
        logits, caches = task.decode_step(model, {
            "tokens": toks[:, Lp + t:Lp + t + 1], "pos": Lp + t + n_vis},
            caches)
        out.append(logits[:, 0])
    return torch.stack(out, 1).cpu()


def _lm_pair(arch, device):
    """The reduced arch's task and seeded model on the CPU, and the same
    parameters in a task and model on ``device``."""
    from repro_torch import configs
    from repro_torch.models import registry, vlm_stub
    from repro_torch.models.transformer import DecoderLM

    cfg = configs.get_config(arch, reduced=True)
    host_task = registry.make_task(cfg, "cpu")
    host = host_task.init(torch.Generator().manual_seed(0))
    task = registry.make_task(cfg, device)
    model = DecoderLM(cfg, device)
    model.load_state_dict(host.state_dict())
    patch = None
    if cfg.vision_tokens:
        patch = vlm_stub.synthetic_patch_embeds(
            torch.Generator().manual_seed(1), 2, cfg.vision_tokens,
            cfg.d_model, cfg.dtype)
    toks = torch.randint(0, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(2))
    return cfg, (host_task, host), (task, model), patch, toks


@pytest.mark.cuda
@pytest.mark.parametrize("arch,Lp", [(a, 8) for a in LM_ARCHS]
                         + [("gemma2-2b", 17)])
def test_lm_decode_on_the_card_matches_forward_and_cpu(cuda, arch, Lp):
    """Reduced width, fp32, TF32 off: each decode step's logits equal the
    card's teacher-forced forward and the CPU's decode within 1e-4 (at 17
    prompt tokens gemma2's window-16 ring has wrapped)."""
    cfg, (host_task, host), (task, model), patch, toks = _lm_pair(arch,
                                                                   cuda)
    steps = toks.shape[1] - Lp
    on_card = _lm_run(task, model, toks.to(cuda), Lp, steps,
                      None if patch is None else patch.to(cuda))
    on_host = _lm_run(host_task, host, toks, Lp, steps, patch)
    n_vis = cfg.vision_tokens
    positions = torch.arange(toks.shape[1] + n_vis, device=cuda)[None]
    with torch.no_grad():
        hidden, _, _ = model.forward(
            toks.to(cuda), positions.expand(2, -1),
            patch_embeds=None if patch is None else patch.to(cuda))
        forward = model.logits(hidden[:, n_vis + Lp - 1:]).cpu()
    torch.testing.assert_close(on_card, forward, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(on_card, on_host, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 1.2])
def test_lm_generate_is_deterministic_on_the_card(cuda, temperature):
    from repro_torch.serve import engine

    _, _, (task, model), _, toks = _lm_pair("gemma2-2b", cuda)
    eng = engine.Engine(task, model)
    gcfg = engine.GenerateConfig(max_new_tokens=24, temperature=temperature,
                                 seed=3)
    prompts = toks[:, :6].numpy().astype("int32")
    first = eng.generate(prompts, gcfg)
    assert first.shape == (2, 24)
    assert (first == eng.generate(prompts, gcfg)).all()


# ---------------------------------------------------------------------------
# LM serving for the moe family (MLA and the scatter MoE FFN): no kernel
# lies on it either
# ---------------------------------------------------------------------------

MOE_ARCHS = ["deepseek-v2-236b", "qwen2-moe-a2.7b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_on_the_card_matches_forward_and_cpu(cuda, arch):
    """Reduced width (dropless), fp32, TF32 off: each decode step's logits
    equal the card's teacher-forced forward and the CPU's decode within
    1e-4."""
    cfg, (host_task, host), (task, model), _, toks = _lm_pair(arch, cuda)
    Lp = 8
    steps = toks.shape[1] - Lp
    on_card = _lm_run(task, model, toks.to(cuda), Lp, steps, None)
    on_host = _lm_run(host_task, host, toks, Lp, steps, None)
    positions = torch.arange(toks.shape[1], device=cuda)[None]
    with torch.no_grad():
        hidden, _, aux = model.forward(toks.to(cuda),
                                       positions.expand(2, -1))
        forward = model.logits(hidden[:, Lp - 1:]).cpu()
    assert aux.device.type == "cuda"
    torch.testing.assert_close(on_card, forward, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(on_card, on_host, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dispatch_on_the_card_matches_cpu(cuda, arch):
    """cf = 1.0 over 64 tokens drops pairs: the card routes and drops the
    CPU's pairs, its output agrees within 1e-5, and a rerun gives the same
    bits (the dispatch writes each row once, with no float atomics)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import moe

    cfg = dataclasses.replace(configs.get_config(arch, reduced=True),
                              capacity_factor=1.0)
    host = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    card = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu").to(cuda)
    x = torch.randn(4, 16, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    want, want_aux = moe.apply_moe(host, x, cfg)
    got, got_aux = moe.apply_moe(card, x.to(cuda), cfg)
    again, _ = moe.apply_moe(card, x.to(cuda), cfg)
    assert torch.equal(got, again)
    _, e_host, _ = moe._route(host, x.reshape(64, -1), cfg)
    _, e_card, _ = moe._route(card, x.reshape(64, -1).to(cuda), cfg)
    assert torch.equal(e_card.cpu(), e_host)
    keep = moe._slots(e_card, cfg)[2]
    assert not bool(keep.all())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_aux.cpu(), want_aux, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# LM serving for the ssm and hybrid families (the SSD and RG-LRU mixers):
# no kernel lies on it either
# ---------------------------------------------------------------------------

RECURRENT_ARCHS = ["mamba2-130m", "recurrentgemma-9b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,Lp", [(a, 8) for a in RECURRENT_ARCHS]
                         + [("mamba2-130m", 13), ("recurrentgemma-9b", 17)])
def test_recurrent_decode_on_the_card_matches_forward_and_cpu(cuda, arch,
                                                              Lp):
    """Reduced width, fp32, TF32 off: each decode step's logits equal the
    card's teacher-forced forward and the CPU's decode within 1e-4 (13
    tokens: mamba2's last chunk of 8 padded; 17: recurrentgemma's window-16
    ring wrapped)."""
    cfg, (host_task, host), (task, model), _, toks = _lm_pair(arch, cuda)
    steps = toks.shape[1] - Lp
    on_card = _lm_run(task, model, toks.to(cuda), Lp, steps, None)
    on_host = _lm_run(host_task, host, toks, Lp, steps, None)
    positions = torch.arange(toks.shape[1], device=cuda)[None]
    with torch.no_grad():
        hidden, _, _ = model.forward(toks.to(cuda), positions.expand(2, -1))
        forward = model.logits(hidden[:, Lp - 1:]).cpu()
    torch.testing.assert_close(on_card, forward, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(on_card, on_host, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_mixer_on_the_card_matches_cpu(cuda, arch):
    """One SSD or RG-LRU mixer at reduced width from a nonzero state: a
    13-position prefill, then 4 decode steps; every output, state and
    conv row on the card within 1e-5 of the CPU's, and a rerun the same
    bits."""
    from repro_torch import configs
    from repro_torch.models import rglru, ssm

    cfg = configs.get_config(arch, reduced=True)
    if arch == "mamba2-130m":
        init, init_cache, apply = ssm.init_ssm, ssm.init_ssm_cache, \
            ssm.apply_ssm
    else:
        init, init_cache, apply = rglru.init_rglru, rglru.init_rglru_cache, \
            rglru.apply_rglru
    host = init(torch.Generator().manual_seed(0), cfg, "cpu")
    card = init(torch.Generator().manual_seed(0), cfg, "cpu").to(cuda)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 17, cfg.d_model, generator=gen)
    cache = type(init_cache(cfg, 2))(*(torch.randn(a.shape, generator=gen)
                                       for a in init_cache(cfg, 2)))

    def run(p, x, cache):
        outs = []
        with torch.no_grad():
            out, cache = apply(p, x[:, :13], cfg, cache=cache)
            outs.append(out)
            for t in range(13, 17):
                out, cache = apply(p, x[:, t:t + 1], cfg, cache=cache,
                                   decode=True)
                outs.append(out)
        return [o.cpu() for o in outs] + [c.cpu() for c in cache]

    want = run(host, x, cache)
    got = run(card, x.to(cuda), type(cache)(*(c.to(cuda) for c in cache)))
    again = run(card, x.to(cuda), type(cache)(*(c.to(cuda) for c in cache)))
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_short_local_cache_grows_on_the_card(cuda):
    """recurrentgemma at window 96: a 5-token prompt's local caches hold
    69 slots and grow into the 96-slot ring at decode; 100 steps on the
    card equal the card's teacher-forced forward within 1e-4."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import registry
    from repro_torch.models.transformer import DecoderLM

    cfg = dataclasses.replace(
        configs.get_config("recurrentgemma-9b", reduced=True), window=96)
    task = registry.make_task(cfg, cuda)
    model = DecoderLM(cfg, cuda)
    model.load_state_dict(DecoderLM(cfg, "cpu").init(
        torch.Generator().manual_seed(0)).state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 105),
                         generator=torch.Generator().manual_seed(3)).to(cuda)
    on_card = _lm_run(task, model, toks, 5, 100, None)
    with torch.no_grad():
        hidden, _, _ = model.forward(toks, torch.arange(105, device=cuda)[
            None].expand(2, -1))
        forward = model.logits(hidden[:, 4:]).cpu()
    torch.testing.assert_close(on_card, forward, rtol=1e-4, atol=1e-4)
