"""Serving: the batched link-prediction engine (``kg_engine.py``)."""
