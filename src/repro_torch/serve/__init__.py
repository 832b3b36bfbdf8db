"""Serving: the knowledge graph's link-prediction faces.

  * ``kg_engine.KGQueryEngine``: the *batch* face.  Top-k over a
    pre-formed query batch on the device; what
    ``repro_torch.kb.KnowledgeBase`` answers offline batches with.
  * ``server.KGServer``: the *live* face.  Individual requests arrive
    asynchronously; a batcher thread forms them into waves
    (``max_batch`` / ``max_wait_us``), pads each wave to a power-of-two
    bucket that ``warmup()`` ran ahead (zero steady-state recompiles),
    answers hot queries from a fingerprint-keyed LRU cache, and hot-swaps
    ``KnowledgeBase`` artifacts with zero downtime.
"""
from repro_torch.serve.kg_engine import (  # noqa: F401
    KGQueryEngine, QueryResult)
from repro_torch.serve.server import (  # noqa: F401
    KGServer, ServedAnswer, ServerStats)
