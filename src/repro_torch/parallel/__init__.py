"""The ``shard_map`` backend's mesh and collectives over
``torch.distributed`` (``parallel/util.py``)."""
