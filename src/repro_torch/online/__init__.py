"""Online knowledge tier (port of ``repro.online``): a trained
``KnowledgeBase`` as a living artifact.

  * ``OnlineUpdater``: ``update(new_triples)`` grows the tables for unseen
    entities and relations (ids interned as a fresh ``load_tsv_dir``
    would), warm-initialises the new entity rows from their neighbours,
    fine-tunes only the rows the delta touches (a masked
    ``mapreduce.train`` on the sparse transport) and returns a new
    artifact, optionally appending a delta checkpoint to a chain
    (``train/checkpoint.save_delta`` / ``KnowledgeBase.load_chain``).
  * ``RefreshDaemon``: serve while training.  A background thread drains
    an update queue through ``OnlineUpdater`` and swaps each refreshed
    artifact into a live ``KGServer`` through its warmed ``swap()``.
"""
from repro_torch.online.updater import (  # noqa: F401
    OnlineUpdater, RefreshDaemon, UpdatePlan)
