"""The port's evaluation protocol (``core/eval.py`` host engine and
``core/eval_device.py`` device engine) against the reference's frozen host
engine, on ``tiny_kg`` with the reference's TransE init carried across.

Rank vectors — raw, filtered and relation — must be equal exactly, and so
must the metric dicts; triplet classification sees the reference's own
corruption draws (injected into the port graph's cache) and must give the
same accuracy.  Energies agree to a few ulps (test_torch_models.py), and
on these inputs no candidate lies that close to a gold.
"""
import numpy as np
import pytest

from repro.core import eval as ref_eval
from repro_torch.core import eval as port_eval
from repro_torch.core import eval_device as port_device

from test_torch_parity_helpers import (
    DIM, port_graph, port_params, ref_tables)
from test_torch_rank_worker import single_rank_mesh


@pytest.fixture(scope="module")
def setup(tiny_kg):
    tables = ref_tables(tiny_kg.n_entities, tiny_kg.n_relations, DIM)
    return tiny_kg, port_graph(tiny_kg), tables, port_params(tables)


@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_rank_vectors_exact(setup, norm):
    ref_g, port_g, tables, params = setup
    want = ref_eval.entity_inference(
        tables, ref_g.test, norm, ref_g.known_set(),
        known_index=ref_g.known_index(), return_ranks=True)
    _, want_rel = ref_eval.relation_prediction(
        tables, ref_g.test, norm, return_ranks=True)
    host = port_eval.entity_inference(
        params, port_g.test, norm, port_g.known_set(),
        known_index=port_g.known_index(), return_ranks=True)
    _, host_rel = port_eval.relation_prediction(
        params, port_g.test, norm, return_ranks=True)
    dev = port_device.entity_ranks_device(
        params, port_g.test, norm, port_g.eval_filter_candidates(),
        relations=True, chunk=48)        # ragged last chunk
    assert dev["raw_ranks"]["tail"].dtype == np.int32
    for got in (host, dev):
        for group in ("raw_ranks", "filtered_ranks"):
            for side in ("tail", "head"):
                np.testing.assert_array_equal(got[group][side],
                                              want[group][side])
    np.testing.assert_array_equal(host_rel, want_rel)
    np.testing.assert_array_equal(dev["relation_ranks"], want_rel)
    _, dev_rel = port_device.relation_prediction_device(
        params, port_g.test, norm, chunk=100, return_ranks=True)
    np.testing.assert_array_equal(dev_rel, want_rel)


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("norm", ["l1", "l2"])
def test_evaluate_all_metrics_equal(setup, engine, norm):
    ref_g, port_g, tables, params = setup
    want = ref_eval.evaluate_all(tables, ref_g, norm, engine="host")
    got = port_eval.evaluate_all(params, port_g, norm, engine=engine)
    assert got == want
    unfiltered = port_eval.evaluate_all(params, port_g, norm,
                                        filtered=False, engine=engine)
    assert "entity_filtered" not in unfiltered
    assert unfiltered["entity_raw"] == want["entity_raw"]


def test_fused_on_cpu_runs_the_plain_kernel(setup):
    """``fused=True`` on CPU tables ranks through the rank kernel's plain
    version; its mean raw rank equals the exact path's (the check the
    reference makes for its kernel), and under L1 every rank does."""
    _, port_g, _, params = setup
    exact = port_device.entity_ranks_device(params, port_g.test, "l1")
    fused = port_device.entity_ranks_device(params, port_g.test, "l1",
                                            fused=True)
    for side in ("tail", "head"):
        assert float(np.mean(fused["raw_ranks"][side])) == pytest.approx(
            float(np.mean(exact["raw_ranks"][side])), rel=1e-6)
        np.testing.assert_array_equal(fused["raw_ranks"][side],
                                      exact["raw_ranks"][side])


def test_engine_options(setup, tmp_path):
    _, port_g, _, params = setup
    assert port_device._resolve_fused(
        port_device.get_model("transe"), None, params) is False
    # sharded tables over a mesh are item 12d; replicated ones over a
    # one-rank mesh give the vmap engine's metrics
    with pytest.raises(NotImplementedError, match="item 12d"):
        port_eval.evaluate_all(params, port_g, engine="device",
                               table_sharding="sharded", n_workers=3,
                               backend="shard_map", mesh=object())
    with single_rank_mesh(tmp_path) as mesh:
        assert port_eval.evaluate_all(
            params, port_g, engine="device", n_workers=3,
            backend="shard_map", mesh=mesh) == port_eval.evaluate_all(
                params, port_g, engine="device")
    # the vmap backend's sharded scan gives the replicated metrics
    assert port_eval.evaluate_all(
        params, port_g, engine="device", table_sharding="sharded",
        n_workers=3) == port_eval.evaluate_all(params, port_g,
                                               engine="device")
    with pytest.raises(ValueError, match="engine='device'"):
        port_eval.evaluate_all(params, port_g, chunk=64)
    with pytest.raises(ValueError, match="bad engine"):
        port_eval.evaluate_all(params, port_g, engine="tpu")


@pytest.mark.parametrize("n,chunk", [(1, 256), (256, 256), (257, 256),
                                     (10, 3)])
def test_layout(n, chunk):
    S, C, padded = port_device.shard_layout(n, chunk, 1)
    assert C == chunk and S * C == padded >= n > padded - C
    arr = np.arange(3 * n).reshape(n, 3)
    out = port_device._pad_rows(arr, padded)
    np.testing.assert_array_equal(out[:n], arr)
    np.testing.assert_array_equal(out[n:], np.broadcast_to(
        arr[:1], (padded - n, 3)))
