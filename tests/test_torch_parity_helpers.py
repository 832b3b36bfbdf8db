"""Shared helpers of the ``repro_torch`` parity tests (no tests here).

Every parity test feeds the same numpy inputs to the JAX reference
(``repro``) and to the port (``repro_torch``), both on the CPU, and
compares the results as numpy arrays.  Later slices may extend these.
"""
import jax
import numpy as np
import torch

from repro.core.models import get_model as ref_get_model
from repro.core.models.base import KGConfig as RefKGConfig
from repro_torch import convert
from repro_torch.data import kg as port_kg_lib

# the conftest ``tiny_kg`` graph
TINY_KG = dict(n_entities=300, n_relations=6, n_triplets=2500)
DIM = 16


def ref_tables(n_entities: int, n_relations: int, dim: int = DIM,
               seed: int = 0) -> dict:
    """The reference TransE init (``jax.random`` seed ``seed``) as numpy
    tables — the tables every parity test carries across."""
    params = ref_get_model("transe").init_params(
        jax.random.PRNGKey(seed), RefKGConfig(n_entities, n_relations, dim))
    return {name: np.asarray(arr) for name, arr in params.items()}


def port_params(tables: dict, dtype=torch.float32) -> dict:
    """``tables`` carried into the port on the CPU."""
    return convert.params_from_reference(tables, device="cpu", dtype=dtype)


def port_graph(ref_graph) -> port_kg_lib.KG:
    """A port ``KG`` with the reference graph's splits and, in its
    triplet-classification cache, the reference's own corruption draws
    (``KG.tc_negatives(0)``): the two packages draw different random
    numbers, so the parity tests inject them."""
    graph = port_kg_lib.KG(
        ref_graph.n_entities, ref_graph.n_relations,
        ref_graph.train, ref_graph.valid, ref_graph.test)
    graph._tc_negatives[0] = ref_graph.tc_negatives(0)
    return graph
