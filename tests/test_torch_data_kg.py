"""``repro_torch.data.kg`` and ``repro_torch.core.negative`` against the
reference: the graph data is numpy in both packages, so every array must
be equal exactly; the negative draws are injected."""
import jax
import numpy as np
import pytest
import torch

from repro.core import negative as ref_negative
from repro.data import kg as ref_kg_lib
from repro_torch.core import negative as port_negative
from repro_torch.data import kg as port_kg_lib

from test_torch_parity_helpers import TINY_KG


@pytest.fixture(scope="module")
def graphs():
    return (ref_kg_lib.synthetic_kg(0, **TINY_KG),
            port_kg_lib.synthetic_kg(0, **TINY_KG))


def _assert_same_graph(ref, port):
    assert (port.n_entities, port.n_relations) == (
        ref.n_entities, ref.n_relations)
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(port, split),
                                      getattr(ref, split))
        assert getattr(port, split).dtype == getattr(ref, split).dtype


@pytest.mark.parametrize("seed,kw", [
    (0, TINY_KG),
    (3, dict(n_entities=120, n_relations=4, n_triplets=900, latent_dim=8,
             noise=0.1, valid_frac=0.1, test_frac=0.2)),
])
def test_synthetic_kg_exact(seed, kw):
    _assert_same_graph(ref_kg_lib.synthetic_kg(seed, **kw),
                       port_kg_lib.synthetic_kg(seed, **kw))


def test_known_structures_exact(graphs):
    ref, port = graphs
    assert port.known_set() == ref.known_set()
    assert port.known_index() == ref.known_index()
    assert port.fingerprint() == ref.fingerprint()


@pytest.mark.parametrize("max_fanout", [None, 2])
def test_eval_filter_candidates_exact(graphs, max_fanout):
    ref, port = graphs
    if max_fanout is None:
        want, got = (ref.eval_filter_candidates(max_fanout),
                     port.eval_filter_candidates(max_fanout))
    else:
        with pytest.warns(UserWarning, match="truncates") as ref_w:
            want = ref.eval_filter_candidates(max_fanout)
        with pytest.warns(UserWarning, match="truncates") as port_w:
            got = port.eval_filter_candidates(max_fanout)
        assert str(port_w[0].message) == str(ref_w[0].message)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("side", ["tail", "head"])
def test_known_candidate_masks_exact(graphs, side):
    ref, port = graphs
    test = ref.test
    pairs = test[:, :2] if side == "tail" else test[:, 1:]
    # add pairs the graph has never seen: all-pad rows
    pairs = np.concatenate([pairs, [[299, 5], [0, 0]]]).astype(np.int32)
    np.testing.assert_array_equal(port.known_candidate_masks(pairs, side),
                                  ref.known_candidate_masks(pairs, side))


def test_load_tsv_dir_exact(tmp_path):
    rows = {
        "train.txt": ["a\tlikes\tb", "b\tlikes\tc", "c\thates\ta",
                      "malformed line", "d\tlikes\ta"],
        "valid.txt": ["a\thates\td"],
        # no test.txt: an empty split
    }
    for name, lines in rows.items():
        (tmp_path / name).write_text("\n".join(lines) + "\n")
    ref = ref_kg_lib.load_tsv_dir(str(tmp_path))
    port = port_kg_lib.load_tsv_dir(str(tmp_path))
    _assert_same_graph(ref, port)
    assert port.test.shape == (0, 3)
    assert port.fingerprint() == ref.fingerprint()


def test_corrupt_unif_injected_draws_match_reference(graphs):
    """The reference's own draws, handed to the port, give the
    reference's corrupted triplets."""
    ref, _ = graphs
    key = jax.random.PRNGKey(11)
    E = ref.n_entities
    want = np.asarray(ref_negative.corrupt_unif(key, ref.valid, E))
    k_side, k_ent = jax.random.split(key)
    B = len(ref.valid)
    head = np.asarray(jax.random.bernoulli(k_side, 0.5, (B,)))
    offset = np.asarray(jax.random.randint(k_ent, (B,), 1, E))
    got = port_negative.corrupt_unif(
        torch.tensor(ref.valid), E, corrupt_head=torch.tensor(head),
        offset=torch.tensor(offset))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32


def test_tc_negatives_port_draws(graphs):
    """The port's own draws: seeded, cached, and each negative differs
    from its positive on exactly one side (Eq. 2)."""
    _, port = graphs
    fresh = port_kg_lib.KG(port.n_entities, port.n_relations, port.train,
                           port.valid, port.test)
    vneg, tneg = port.tc_negatives(0)
    assert port.tc_negatives(0)[0] is vneg
    np.testing.assert_array_equal(fresh.tc_negatives(0)[1], tneg)
    for pos, neg in ((port.valid, vneg), (port.test, tneg)):
        assert neg.shape == pos.shape and neg.dtype == np.int32
        np.testing.assert_array_equal(neg[:, 1], pos[:, 1])
        changed = (neg[:, 0] != pos[:, 0]).astype(int) + (
            neg[:, 2] != pos[:, 2])
        np.testing.assert_array_equal(changed, 1)
        assert neg.min() >= 0 and neg[:, (0, 2)].max() < port.n_entities
