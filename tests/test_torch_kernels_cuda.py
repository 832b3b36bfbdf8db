"""The port's CUDA kernels against their plain versions, on a card.

Each test is marked ``cuda`` and skips without a CUDA device (a kernel has
no CPU mode).  The file imports neither jax nor the reference, so it runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py
"""
import pytest
import torch

from repro_torch.core import eval_device
from repro_torch.core.models import KGConfig, get_model
from repro_torch.data import kg as kg_data
from repro_torch.kernels import ref, rank_topk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("B,E,k", [(256, 14951, 50), (70, 1000, 7),
                                   (3, 129, 256)])
def test_rank_counts_matches_plain(cuda, B, E, k, norm, dtype):
    """Equal counts, not close ones: the kernel and its plain version do
    the same fp32 operations in the same order.  Shapes: the evaluation
    chunk at FB15k size; ragged query and table tiles; the widest k."""
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
